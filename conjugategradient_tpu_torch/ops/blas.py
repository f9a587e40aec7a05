"""Device BLAS-1: dot / axpy / scal / norms, as plain PyTorch ops.

All three residual-norm conventions of the reference are provided.  The
reductions run over every axis, so grid-shaped solver state and flat
vectors share one code path.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor, precise: bool = False) -> torch.Tensor:
    """Inner product as a 0-d tensor.  ``precise=True`` uses the compensated
    ``ops.precision.kahan_dot``."""
    if precise:
        from conjugategradient_tpu_torch.ops.precision import kahan_dot

        return kahan_dot(a, b)
    return torch.dot(a.reshape(-1), b.reshape(-1))


def axpy(alpha, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """y + alpha * x."""
    return y + alpha * x


def scal(alpha, x: torch.Tensor) -> torch.Tensor:
    return alpha * x


def max_abs(a: torch.Tensor) -> torch.Tensor:
    """‖a‖∞."""
    return torch.max(torch.abs(a))


def norm_l2(a: torch.Tensor, precise: bool = False) -> torch.Tensor:
    return torch.sqrt(dot(a, a, precise=precise))


def residual_norm(r: torch.Tensor, rr, rr0, norm: str) -> torch.Tensor:
    """Residual in the selected convention; ``rr`` = r.r from the recurrence,
    so ``l2``/``rel_l2`` cost no extra pass and ``linf`` one reduction."""
    if norm == "l2":
        return torch.sqrt(rr)
    if norm == "linf":
        return max_abs(r)
    if norm == "rel_l2":
        return torch.sqrt(rr / rr0)
    raise ValueError(f"unknown norm {norm!r}")
