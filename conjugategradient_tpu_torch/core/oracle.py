"""Pure-numpy fp64 CPU oracle: the ground truth for true-residual checks.

A copy of the DIA part of ``conjugategradient_tpu/core/oracle.py``: the
SpMV, the three residual-norm conventions and textbook CG with the
reference's convergence policy (``method="oracle"`` of ``api.solve``).

- ``l2``      — sqrt(r.r)
- ``linf``    — max|r|
- ``rel_l2``  — sqrt(r.r / r0.r0)
"""

from __future__ import annotations

import dataclasses

import numpy as np

from conjugategradient_tpu_torch.core.formats import DiaMatrix


class NotConvergedError(RuntimeError):
    """Raised by ``cg`` past max_iteration."""


def dot(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.dot(a, b))


def axpy(alpha: float, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """y + alpha*x."""
    return y + alpha * x


def max_absolute(a: np.ndarray) -> float:
    return float(np.max(np.abs(a))) if a.size else 0.0


def spmv(A, x: np.ndarray) -> np.ndarray:
    """y = A x for a host ``DiaMatrix``, in the promoted dtype of A and x."""
    if not isinstance(A, DiaMatrix):
        raise NotImplementedError(
            f"oracle.spmv of {type(A).__name__} is not ported yet "
            "(ROADMAP queue 1: other formats and ingestion)"
        )
    x = np.asarray(x)
    n = A.n
    data = np.asarray(A.data)
    y = np.zeros(n, dtype=np.result_type(data.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        y[i0:i1] += data[k, i0:i1] * x[i0 + off : i1 + off]
    return y


def residual_norm(r: np.ndarray, rr: float, rr0: float, norm: str) -> float:
    if norm == "l2":
        return float(np.sqrt(rr))
    if norm == "linf":
        return max_absolute(r)
    if norm == "rel_l2":
        return float(np.sqrt(rr / rr0)) if rr0 > 0 else 0.0
    raise ValueError(f"unknown norm {norm!r}")


@dataclasses.dataclass
class OracleResult:
    x: np.ndarray
    iterations: int
    residual: float
    converged: bool
    history: list


def cg(
    A,
    b: np.ndarray,
    x0: np.ndarray | None = None,
    *,
    tol: float = 1e-8,
    norm: str = "l2",
    min_iteration: int = 0,
    max_iteration: int | None = None,
    M=None,
    record_history: bool = False,
    raise_on_divergence: bool = True,
) -> OracleResult:
    """Textbook (preconditioned) CG in fp64 with the reference's policy:
    below ``min_iteration`` never converged; past ``max_iteration`` raise (or
    flag); otherwise converged when the selected residual drops below
    ``tol``.  ``M`` is an optional preconditioner callable ``z = M(r)``."""
    n = len(b)
    b = np.asarray(b, dtype=np.float64)
    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    if max_iteration is None:
        max_iteration = n

    r = b - spmv(A, x)
    z = M(r) if M is not None else r
    p = z.copy()
    rz = dot(r, z)
    rr0 = dot(r, r)
    history = []

    iteration = 0
    residual = residual_norm(r, rr0, rr0, norm)
    converged = iteration >= min_iteration and residual < tol
    while not converged:
        if iteration >= max_iteration:
            if raise_on_divergence:
                raise NotConvergedError(
                    f"CG did not converge in {max_iteration} iterations (residual={residual:.3e})"
                )
            return OracleResult(x, iteration, residual, False, history)
        Ap = spmv(A, p)
        alpha = rz / dot(p, Ap)
        x = axpy(alpha, p, x)
        r = axpy(-alpha, Ap, r)
        z = M(r) if M is not None else r
        rz_new = dot(r, z)
        rr = dot(r, r)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        iteration += 1
        residual = residual_norm(r, rr, rr0, norm)
        if record_history:
            history.append(residual)
        converged = iteration >= min_iteration and residual < tol
    return OracleResult(x, iteration, residual, True, history)
