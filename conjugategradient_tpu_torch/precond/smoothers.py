"""Smoothers and simple preconditioners built from SpMV and axpy: point
Jacobi, weighted Jacobi, Chebyshev (smoother and fixed-degree polynomial
preconditioner) and red-black Gauss-Seidel.  The port of
``conjugategradient_tpu/precond/smoothers.py``."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


def jacobi_preconditioner(inv_diag: torch.Tensor) -> Callable[[torch.Tensor], torch.Tensor]:
    """Point-Jacobi M^{-1} r = D^{-1} r, one multiply."""
    return lambda r: inv_diag * r


def jacobi_smooth(
    op: Operator,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    iters: int,
    omega: float = 2.0 / 3.0,
) -> torch.Tensor:
    """``iters`` sweeps of weighted Jacobi: x += omega D^{-1} (b - A x)."""
    for _ in range(iters):
        x = x + omega * (inv_diag * (b - op(x)))
    return x


def chebyshev_smooth(
    op: Operator,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    degree: int,
    lam_max: float,
    lam_min: float,
) -> torch.Tensor:
    """Chebyshev polynomial smoothing of the Jacobi-scaled system: damps the
    D^{-1}A error components in [lam_min, lam_max] with the classic
    three-term recurrence, ``degree`` SpMVs plus axpys."""
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    r = inv_diag * (b - op(x))
    d = r / theta
    for _ in range(degree):
        x = x + d
        r = r - inv_diag * op(d)
        rho_new = 1.0 / (2.0 * sigma - rho)
        d = (rho_new * rho) * d + (2.0 * rho_new / delta) * r
        rho = rho_new
    return x


def chebyshev_preconditioner(
    op: Operator,
    inv_diag: torch.Tensor,
    degree: int,
    lam_min: float,
    lam_max: float,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Fixed-degree Chebyshev polynomial preconditioner M r = p(D^{-1}A)
    D^{-1} r: ``degree`` SpMVs and axpys per application, a fixed linear
    SPD operator, so plain CG applies.  The bounds must cover the whole
    spectrum of D^{-1}A (``chebyshev_preconditioner_for`` estimates them),
    unlike the smoothing interval [lam_max/4, lam_max] of multigrid."""
    if not (0.0 < lam_min < lam_max):
        raise ValueError(f"need 0 < lam_min < lam_max, got [{lam_min}, {lam_max}]")

    def M(r):
        return chebyshev_smooth(op, inv_diag, r, torch.zeros_like(r), degree, lam_max, lam_min)

    return M


def chebyshev_preconditioner_for(A, degree: int = 3, k: int = 30, A_dev=None, dtype=None,
                                 device=None):
    """Estimate spec(D^{-1}A) on the host and return ``(M, (lam_min,
    lam_max))`` for the device operator of the host container ``A``.

    The bounds come from ``k``-step Lanczos on the symmetric similar
    operator ``D^{-1/2} A D^{-1/2}`` (same spectrum as D^{-1}A), floored at
    ``1e-3 * lam_max`` when the lower estimate is not positive and widened
    by 0.9 / 1.1 (Ritz values are interior), the JAX package's numbers bit
    for bit.  ``A_dev`` and ``dtype`` let a caller that already placed the
    matrix reuse it (one device copy, M at the solver's dtype); otherwise
    ``A`` is placed on ``device`` (``None``: the card when there is
    one)."""
    from conjugategradient_tpu_torch.core import oracle
    from conjugategradient_tpu_torch.core.formats import matrix_diagonal, torch_dtype
    from conjugategradient_tpu_torch.ops.spmv import as_operator
    from conjugategradient_tpu_torch.solvers import eigen

    d = matrix_diagonal(A)
    if np.any(d <= 0):
        raise ValueError("Chebyshev preconditioning needs a positive diagonal")
    d_isqrt = 1.0 / np.sqrt(d)
    lo, hi = eigen.lanczos_bounds(lambda v: d_isqrt * oracle.spmv(A, d_isqrt * v), A.n, k)
    if not (lo > 0):  # Lanczos underestimate hit zero: fall back to a floor
        lo = max(lo, 1e-3 * hi)
    lo, hi = 0.9 * lo, 1.1 * hi
    if A_dev is None:
        A_dev = A.device_put(dtype, device)
    dt = torch_dtype(dtype) if dtype is not None else A_dev.data.dtype
    inv_d = torch.from_numpy(1.0 / d).to(device=A_dev.data.device, dtype=dt)
    return chebyshev_preconditioner(as_operator(A_dev), inv_d, degree, lo, hi), (lo, hi)


def parity_mask(grid) -> torch.Tensor:
    """Checkerboard mask over a tensor grid: True where sum(indices) is
    even."""
    return torch.from_numpy(np.indices(grid).sum(axis=0) % 2 == 0)


def redblack_gs_smooth(
    op: Operator,
    inv_diag: torch.Tensor,
    b: torch.Tensor,
    x: torch.Tensor,
    iters: int,
    mask: torch.Tensor,
) -> torch.Tensor:
    """Red-black Gauss-Seidel in its two-color (data-parallel) form: each
    half-sweep updates one checkerboard color from the latest values of the
    other, one full stencil product per half-sweep.  Exact Gauss-Seidel
    ordering for 2-colorable stencils (5/7-point), a hybrid block sweep for
    wider ones.  Red then black; ``redblack_gs_smooth_reversed`` is the
    adjoint ordering, for symmetric post-smoothing."""
    for _ in range(iters):
        x = torch.where(mask, x + inv_diag * (b - op(x)), x)
        x = torch.where(mask, x, x + inv_diag * (b - op(x)))
    return x


def redblack_gs_smooth_reversed(op, inv_diag, b, x, iters, mask):
    """Black then red sweeps: the adjoint ordering of ``redblack_gs_smooth``."""
    for _ in range(iters):
        x = torch.where(mask, x, x + inv_diag * (b - op(x)))
        x = torch.where(mask, x + inv_diag * (b - op(x)), x)
    return x
