"""Grid transfers: restriction and prolongation on tensor grids.

The port of ``conjugategradient_tpu/precond/transfer.py``.  A d-dimensional
grid of interior (Dirichlet) points; every d-dimensional operator is a
per-axis tensor product, applied axis by axis with strided slices, on
tensors of either device by one code path.  Results are contiguous, as the
stencil kernels need.  The same operators are assembled as scipy matrices
for the host-side Galerkin product, so the coarse operators and the
V-cycle's transfers are transposes of each other (R = P^T / 2 per coarsened
axis): the V-cycle stays symmetric, a valid PCG preconditioner.

Four families:

- **full weighting** (``fw``): odd axes ``n = 2m + 1``, the coarse axis keeps
  the ``m`` odd-indexed points; P interpolates linearly;
- **aggregation** (``agg``): any axis ``n >= 2``, coarse cell j owns fine
  cells {2j, 2j+1} (a lone last cell on an odd axis), P piecewise constant;
- **hybrid** (``hyb``): full weighting on odd axes, cell-centered linear
  interpolation (``cc``) on even axes,
  ``ef[2J] = (3 ec[J] + ec[J-1]) / 4``, ``ef[2J+1] = (3 ec[J] + ec[J+1]) / 4``
  (missing neighbours dropped);
- **partial** (semicoarsening): the hybrid operators on a masked subset of
  axes, identity on the rest.
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


def _along(fn, v: torch.Tensor, ax: int, *args) -> torch.Tensor:
    """``fn`` applied along axis ``ax`` of ``v`` (``fn`` works on the last)."""
    return torch.movedim(fn(torch.movedim(v, ax, -1), *args), -1, ax)


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
        v = _along(_restrict_axis, v, ax)
    return v.contiguous()


def prolong_grid(v: torch.Tensor, fine: GridShape) -> torch.Tensor:
    """Grid-shaped linear prolongation up to ``fine``."""
    for ax in range(len(fine)):
        v = _along(_prolong_axis, v, ax, fine[ax])
    return v.contiguous()


def restrict(r: torch.Tensor, fine: GridShape) -> torch.Tensor:
    """Restrict a flat residual vector from ``fine`` to ``coarse_shape(fine)``."""
    return restrict_grid(r.reshape(fine)).reshape(-1)


def prolong(e: torch.Tensor, fine: GridShape) -> torch.Tensor:
    """Prolong a flat coarse correction up to the flat ``fine`` grid."""
    return prolong_grid(e.reshape(coarse_shape(fine)), fine).reshape(-1)


# ---------------------------------------------------------------------------
# Aggregation: coarsening for any axis size.
# ---------------------------------------------------------------------------


def agg_coarse_shape(fine: GridShape) -> GridShape:
    for n in fine:
        if n < 2:
            raise ValueError(f"axis size {n} not aggregatable; shape={fine}")
    return tuple((n + 1) // 2 for n in fine)


def can_aggregate(fine: GridShape) -> bool:
    return all(n >= 2 for n in fine)


def _restrict_agg_axis(v: torch.Tensor) -> torch.Tensor:
    if v.shape[-1] % 2:
        v = F.pad(v, (0, 1))
    shaped = v.reshape(v.shape[:-1] + (-1, 2))
    return 0.5 * (shaped[..., 0] + shaped[..., 1])


def _prolong_agg_axis(e: torch.Tensor, n_fine: int) -> torch.Tensor:
    return torch.repeat_interleave(e, 2, dim=-1)[..., :n_fine]


def restrict_agg_grid(v: torch.Tensor) -> torch.Tensor:
    for ax in range(v.ndim):
        v = _along(_restrict_agg_axis, v, ax)
    return v.contiguous()


def prolong_agg_grid(v: torch.Tensor, fine: GridShape) -> torch.Tensor:
    for ax in range(len(fine)):
        v = _along(_prolong_agg_axis, v, ax, fine[ax])
    return v.contiguous()


# ---------------------------------------------------------------------------
# Hybrid: full weighting on odd axes, cell-centered on even axes.
# ---------------------------------------------------------------------------


def hybrid_kinds(fine: GridShape):
    """Per-axis transfer choice ("fw" | "cc"), or None if some axis cannot
    coarsen (odd axes need >= 3, even axes >= 2)."""
    kinds = []
    for n in fine:
        if n % 2 == 1 and n >= 3:
            kinds.append("fw")
        elif n % 2 == 0 and n >= 2:
            kinds.append("cc")
        else:
            return None
    return tuple(kinds)


def can_hybrid(fine: GridShape) -> bool:
    return hybrid_kinds(fine) is not None


def hybrid_coarse_shape(fine: GridShape) -> GridShape:
    kinds = hybrid_kinds(fine)
    if kinds is None:
        raise ValueError(f"shape {fine} not hybrid-coarsenable")
    return tuple((n - 1) // 2 if k == "fw" else n // 2 for n, k in zip(fine, kinds))


def _restrict_cc_axis(v: torch.Tensor) -> torch.Tensor:
    """R = P_cc^T / 2 along the last axis (even size n = 2m -> m):
    rc[J] = (3 v[2J] + 3 v[2J+1] + v[2J-1] + v[2J+2]) / 8."""
    n = v.shape[-1]
    m = n // 2
    a = v[..., 0:n:2]
    b = v[..., 1:n:2]
    lft = F.pad(v[..., 1 : 2 * m - 2 : 2], (1, 0)) if m > 1 else torch.zeros_like(a)
    rgt = F.pad(v[..., 2:n:2], (0, 1)) if m > 1 else torch.zeros_like(a)
    return (3.0 * (a + b) + lft + rgt) / 8.0


def _prolong_cc_axis(e: torch.Tensor, n_fine: int) -> torch.Tensor:
    """P_cc along the last axis (m -> 2m)."""
    left = F.pad(e[..., :-1], (1, 0))
    right = F.pad(e[..., 1:], (0, 1))
    even = (3.0 * e + left) / 4.0
    odd = (3.0 * e + right) / 4.0
    return torch.stack([even, odd], dim=-1).reshape(e.shape[:-1] + (n_fine,))


_RESTRICT = {"fw": _restrict_axis, "cc": _restrict_cc_axis}
_PROLONG = {"fw": _prolong_axis, "cc": _prolong_cc_axis}


def restrict_hybrid_grid(v: torch.Tensor) -> torch.Tensor:
    for ax, k in enumerate(hybrid_kinds(tuple(v.shape))):
        v = _along(_RESTRICT[k], v, ax)
    return v.contiguous()


def prolong_hybrid_grid(e: torch.Tensor, fine: GridShape) -> torch.Tensor:
    for ax, k in enumerate(hybrid_kinds(fine)):
        e = _along(_PROLONG[k], e, ax, fine[ax])
    return e.contiguous()


# ---------------------------------------------------------------------------
# Partial (semi-)coarsening: the hybrid operators on the masked axes only.
# ---------------------------------------------------------------------------


def partial_kinds(fine: GridShape, mask):
    """Per-axis choice ("fw" | "cc" | "id"); None if some masked axis
    cannot coarsen."""
    kinds = []
    for n, m in zip(fine, mask):
        if not m:
            kinds.append("id")
        elif n % 2 == 1 and n >= 3:
            kinds.append("fw")
        elif n % 2 == 0 and n >= 2:
            kinds.append("cc")
        else:
            return None
    return tuple(kinds)


def can_partial(fine: GridShape, mask) -> bool:
    return any(mask) and partial_kinds(fine, mask) is not None


def partial_coarse_shape(fine: GridShape, mask) -> GridShape:
    kinds = partial_kinds(fine, mask)
    if kinds is None:
        raise ValueError(f"shape {fine} not partial-coarsenable on {mask}")
    return tuple(
        n if k == "id" else ((n - 1) // 2 if k == "fw" else n // 2)
        for n, k in zip(fine, kinds)
    )


def restrict_partial_grid(v: torch.Tensor, mask) -> torch.Tensor:
    for ax, k in enumerate(partial_kinds(tuple(v.shape), mask)):
        if k != "id":
            v = _along(_RESTRICT[k], v, ax)
    return v.contiguous()


def prolong_partial_grid(e: torch.Tensor, fine: GridShape, mask) -> torch.Tensor:
    for ax, k in enumerate(partial_kinds(fine, mask)):
        if k != "id":
            e = _along(_PROLONG[k], e, ax, fine[ax])
    return e.contiguous()


# ---------------------------------------------------------------------------
# Host-side (scipy) assembly, for the Galerkin product R A P.  Row-major
# vector ordering: axis 0 is outermost, matching ``reshape(fine)``.
# ---------------------------------------------------------------------------


def _kron(mats) -> sp.csr_matrix:
    P = mats[0]
    for M in mats[1:]:
        P = sp.kron(P, M, format="csr")
    return P


def prolong_matrix_1d(n_fine: int) -> sp.csr_matrix:
    """The 1-D full-weighting P as a (n_fine, m) sparse matrix."""
    m = (n_fine - 1) // 2
    rows, cols, vals = [], [], []
    for j in range(m):
        rows += [2 * j, 2 * j + 1, 2 * j + 2]
        cols += [j, j, j]
        vals += [0.5, 1.0, 0.5]
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_matrix(fine: GridShape) -> sp.csr_matrix:
    """d-D full-weighting P as the Kronecker product over axes."""
    return _kron([prolong_matrix_1d(n) for n in fine])


def restrict_matrix(fine: GridShape) -> sp.csr_matrix:
    """R = P^T / 2^d (full weighting)."""
    return (prolong_matrix(fine).T * (0.5 ** len(fine))).tocsr()


def prolong_agg_matrix_1d(n_fine: int) -> sp.csr_matrix:
    m = (n_fine + 1) // 2
    rows = list(range(n_fine))
    cols = [j // 2 for j in rows]
    vals = [1.0] * n_fine
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_agg_matrix(fine: GridShape) -> sp.csr_matrix:
    return _kron([prolong_agg_matrix_1d(n) for n in fine])


def prolong_cc_matrix_1d(n_fine: int) -> sp.csr_matrix:
    m = n_fine // 2
    rows, cols, vals = [], [], []
    for J in range(m):
        rows.append(2 * J); cols.append(J); vals.append(0.75)
        if J >= 1:
            rows.append(2 * J); cols.append(J - 1); vals.append(0.25)
        rows.append(2 * J + 1); cols.append(J); vals.append(0.75)
        if J + 1 < m:
            rows.append(2 * J + 1); cols.append(J + 1); vals.append(0.25)
    return sp.csr_matrix((vals, (rows, cols)), shape=(n_fine, m))


def prolong_hybrid_matrix(fine: GridShape) -> sp.csr_matrix:
    """Mixed per-axis P (fw on odd axes, cc on even) as the Kronecker
    product."""
    return _kron([prolong_matrix_1d(n) if k == "fw" else prolong_cc_matrix_1d(n)
                  for n, k in zip(fine, hybrid_kinds(fine))])


def prolong_partial_matrix(fine: GridShape, mask) -> sp.csr_matrix:
    """Mixed per-axis P with the identity on uncoarsened axes
    (R = P^T / 2^(#coarsened))."""
    mats = []
    for n, k in zip(fine, partial_kinds(fine, mask)):
        if k == "id":
            mats.append(sp.identity(n, format="csr"))
        elif k == "fw":
            mats.append(prolong_matrix_1d(n))
        else:
            mats.append(prolong_cc_matrix_1d(n))
    return _kron(mats).tocsr()
