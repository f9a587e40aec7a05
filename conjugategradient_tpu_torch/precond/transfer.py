"""Grid transfers: full-weighting restriction and linear prolongation.

A d-dimensional grid of interior (Dirichlet) points, each axis of odd size
``n = 2m + 1``; the coarse axis keeps the ``m`` odd-indexed points.  The
d-dimensional operators are per-axis tensor products, applied axis by axis
with strided slices.  Results are contiguous, as the stencil kernels need.
The same operators are assembled as scipy matrices for the host-side
Galerkin product.
"""

from __future__ import annotations

from typing import Tuple

import scipy.sparse as sp
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


def can_aggregate(fine: GridShape) -> bool:
    """Whether pairwise aggregation (the JAX package's fallback for any axis
    size) could coarsen ``fine``; the port has no aggregation transfers, so
    the hierarchy build only uses this to take the same decisions."""
    return all(n >= 2 for n in fine)


def can_partial(fine: GridShape, mask) -> bool:
    """Whether semicoarsening of the ``mask``-ed axes applies: some axis is
    masked and every masked axis can halve (odd >= 3 vertex-centered, even
    >= 2 cell-centered)."""
    return any(mask) and all(n >= 2 for n, m in zip(fine, mask) if m)


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


# ---------------------------------------------------------------------------
# Host-side (scipy) assembly, for the Galerkin product R A P.  The device
# transfers above are exactly these operators, so the coarse operators and
# the V-cycle's transfers are transposes of each other (the V-cycle stays
# symmetric, a valid PCG preconditioner).
# ---------------------------------------------------------------------------


def prolong_matrix_1d(n_fine: int) -> sp.csr_matrix:
    """The 1-D P as a (n_fine, m) sparse matrix."""
    m = (n_fine - 1) // 2
    rows, cols, vals = [], [], []
    for j in range(m):
        rows += [2 * j, 2 * j + 1, 2 * j + 2]
        cols += [j, j, j]
        vals += [0.5, 1.0, 0.5]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_matrix(fine: GridShape) -> sp.csr_matrix:
    """d-D P as the Kronecker product over axes (row-major vector ordering:
    axis 0 is outermost, matching ``reshape(fine)``)."""
    P = prolong_matrix_1d(fine[0])
    for n in fine[1:]:
        P = sp.kron(P, prolong_matrix_1d(n), format="csr")
    return P


def restrict_matrix(fine: GridShape) -> sp.csr_matrix:
    """R = P^T / 2^d (full weighting)."""
    return (prolong_matrix(fine).T * (0.5 ** len(fine))).tocsr()
