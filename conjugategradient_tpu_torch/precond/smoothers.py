"""Smoothers built from SpMV and axpy: weighted Jacobi, Chebyshev and
red-black Gauss-Seidel."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

Operator = Callable[[torch.Tensor], torch.Tensor]


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
