"""Grid transfers: full-weighting restriction and linear prolongation.

A d-dimensional grid of interior (Dirichlet) points, each axis of odd size
``n = 2m + 1``; the coarse axis keeps the ``m`` odd-indexed points.  The
d-dimensional operators are per-axis tensor products, applied axis by axis
with strided slices.  Results are contiguous, as the stencil kernels need.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

GridShape = Tuple[int, ...]


def coarse_shape(fine: GridShape) -> GridShape:
    """Coarse grid shape; every axis must be odd and >= 3."""
    for n in fine:
        if n < 3 or n % 2 == 0:
            raise ValueError(f"axis size {n} not coarsenable (need odd >= 3); shape={fine}")
    return tuple((n - 1) // 2 for n in fine)


def can_coarsen(fine: GridShape) -> bool:
    return all(n >= 3 and n % 2 == 1 for n in fine)


def _restrict_axis(v: torch.Tensor) -> torch.Tensor:
    """Full weighting along the last axis (odd size n -> (n-1)//2)."""
    n = v.shape[-1]
    return 0.25 * v[..., 0 : n - 2 : 2] + 0.5 * v[..., 1 : n - 1 : 2] + 0.25 * v[..., 2:n:2]


def _prolong_axis(e: torch.Tensor, n_fine: int) -> torch.Tensor:
    """Linear interpolation along the last axis ((n-1)//2 -> n)."""
    ep = F.pad(e, (1, 1))
    even = 0.5 * (ep[..., :-1] + ep[..., 1:])  # values at fine 0, 2, ..., 2m
    out = torch.empty(e.shape[:-1] + (n_fine,), dtype=e.dtype, device=e.device)
    out[..., 1::2] = e
    out[..., 0::2] = even
    return out


def restrict_grid(v: torch.Tensor) -> torch.Tensor:
    """Grid-shaped full-weighting restriction along every axis."""
    for ax in range(v.ndim):
        v = torch.movedim(_restrict_axis(torch.movedim(v, ax, -1)), -1, ax)
    return v.contiguous()


def prolong_grid(v: torch.Tensor, fine: GridShape) -> torch.Tensor:
    """Grid-shaped linear prolongation up to ``fine``."""
    for ax in range(len(fine)):
        v = torch.movedim(_prolong_axis(torch.movedim(v, ax, -1), fine[ax]), -1, ax)
    return v.contiguous()
