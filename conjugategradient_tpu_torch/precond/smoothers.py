"""Smoothers built from SpMV and axpy: weighted Jacobi and Chebyshev."""

from __future__ import annotations

from typing import Callable

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
