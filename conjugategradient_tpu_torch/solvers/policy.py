"""Convergence policy: min_iteration / max_iteration / tolerance / norm.

Below ``min_iteration`` a solve is never converged (the comparison is
inclusive: converged requires ``iteration >= min_iteration``); past
``max_iteration`` it stops with ``converged=False``, and
``CGResult.raise_if_diverged()`` turns that into ``NotConvergedError``.
"""

from __future__ import annotations

import dataclasses
import enum


class Norm(str, enum.Enum):
    """The three residual conventions of the reference's backends."""

    L2 = "l2"  # sqrt(r.r)
    LINF = "linf"  # max|r|
    REL_L2 = "rel_l2"  # sqrt(r.r / r0.r0)


@dataclasses.dataclass(frozen=True)
class ConvergencePolicy:
    tol: float = 1e-8
    norm: str = Norm.L2
    min_iteration: int = 0
    max_iteration: int | None = None  # defaults to n at solve time

    def __post_init__(self):
        object.__setattr__(self, "norm", Norm(self.norm).value)
        if self.tol <= 0:
            raise ValueError("tol must be positive")
        if self.min_iteration < 0:
            raise ValueError("min_iteration must be >= 0")
        if self.max_iteration is not None and self.max_iteration < self.min_iteration:
            raise ValueError("max_iteration must be >= min_iteration")

    def resolve_max(self, n: int) -> int:
        """Default cap = n (exact-arithmetic CG termination bound), clamped
        to int32 range: a caller passing ``max_iteration=8*n`` at 347M+ rows
        would otherwise overflow an int32 iteration counter."""
        m = int(self.max_iteration) if self.max_iteration is not None else int(n)
        return min(m, 2**31 - 1)


class NotConvergedError(RuntimeError):
    """Raised by ``CGResult.raise_if_diverged`` past max_iteration."""
