"""Algebraic multigrid (smoothed aggregation) for matrices with no grid.

The port of ``conjugategradient_tpu/precond/amg.py``: the grid-free MGCG
for Matrix Market files, permuted meshes and graph Laplacians.

- **Setup on the host**, the JAX package's numpy and scipy line for line,
  so every host array of the hierarchy is the JAX package's bit for bit:
  strength-of-connection filter, aggregation (N-D cubes over a grid
  inferred from the banded offsets, 1-D strips on a band, or greedy over
  the strength graph by ``native.aggregate``), the near-null tentative
  prolongator, the Jacobi-smoothed ``P = (I - 4/(3 lam_max) D^{-1}A) P0``
  and the Galerkin ``A_c = P^T A P``, each level's operator relaid out to a
  grid stencil, a DIA band or kept CSR.  ``AmgHierarchy.setup_s`` splits
  the host seconds by phase.
- **Cycle on the device**, through ``ops.spmv.spmv``: a
  ``ConstStencilMatrix`` level runs kernel #1, a ``StencilMatrix`` level
  kernel #3, a ``DiaMatrix`` level kernel #4 and a ``CsrMatrix`` level
  cuSPARSE's product (the JAX package has no Pallas kernel for CSR).  The
  smoothers are the unfused ``chebyshev_smooth`` / ``jacobi_smooth``, as
  in the JAX package (kernel #2 is not on this path).  The transfers are
  plain torch in four forms: pad and sum over the block axes (``blk_nd``),
  a reshape sum (``blk``), a fixed-order segment sum and a gather
  (``agg``), or the CSR products of P and R.  Nothing in the cycle adds
  with atomics, so two cycles on the card give the same bits.  The
  coarsest level is ``coarse_inv @ b`` with TF32 off.

The hierarchy is an ``nn.Module``: the level operators' arrays, P, R,
``inv_diag``, ``agg``, ``w`` and ``coarse_inv`` are buffers, so ``.to``
moves it; the static fields are attributes.
"""

from __future__ import annotations

import dataclasses
import time
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    CsrMatrix,
    DiaMatrix,
    StencilMatrix,
    csr_to_dia,
    default_device,
    dia_to_stencil,
    place,
    stencil_to_const,
    to_host,
    torch_dtype,
)
from conjugategradient_tpu_torch.core.io import from_scipy, to_scipy
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import spmv, spmv_csr
from conjugategradient_tpu_torch.precond.smoothers import chebyshev_smooth, jacobi_smooth

#: smoothed-aggregation prolongator damping: c = _SA_W / lam_max(D^{-1}A)
_SA_W = 4.0 / 3.0

#: the tensor fields of each container a level holds as buffers
_ARRAYS = {DiaMatrix: ("data",), StencilMatrix: ("data",),
           CsrMatrix: ("data", "indices", "indptr", "row_ids"), ConstStencilMatrix: ()}


def _segment_rows(agg: np.ndarray, nc: int) -> np.ndarray:
    """``(nc, L)`` row table of the aggregates: row ``j`` lists the rows of
    aggregate ``j`` ascending, padded with ``n`` (an appended zero), so a
    gather and a sum along each row is a segment sum in a fixed order."""
    n = agg.shape[0]
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=nc)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    table = np.full((nc, max(int(counts.max(initial=0)), 1)), n, dtype=np.int64)
    table[agg[order], np.arange(n) - starts[agg[order]]] = order
    return table


class AmgLevel(nn.Module):
    """One algebraic level: its operator ``A``, the prolongator ``P`` and
    restriction ``R = P^T`` (device ``CsrMatrix``), ``inv_diag`` (grid-shaped
    on a stencil level, flat otherwise), the Chebyshev interval
    ``cheb_bounds`` on spec(D^{-1}A), and the composition form of the
    transfers where it is exact: ``P = (I - sa_c D^{-1}A) P0`` with ``(P0
    e)[i] = w[i] * e[agg[i]]``, over ``nc`` aggregates, contiguous strips
    of ``blk`` rows or the N-D cubes ``blk_nd = (grid, block)``.  ``A``,
    ``P`` and ``R`` are rebuilt over their buffers on each access, so
    ``.to(device)`` moves them with the level."""

    def __init__(self, A, P: CsrMatrix, R: CsrMatrix, inv_diag: torch.Tensor,
                 cheb_bounds: Tuple[float, float], agg: Optional[torch.Tensor] = None,
                 w: Optional[torch.Tensor] = None, nc: int = 0, sa_c: float = 0.0,
                 blk: int = 0, blk_nd=None):
        super().__init__()
        self._ops = {}
        for role, M in (("A", A), ("P", P), ("R", R)):
            fields = _ARRAYS[type(M)]
            static = {f.name: getattr(M, f.name) for f in dataclasses.fields(M)
                      if f.name not in fields}
            for f in fields:
                self.register_buffer(f"{role}_{f}", getattr(M, f))
            self._ops[role] = (type(M), fields, static)
        self.register_buffer("inv_diag", inv_diag)
        self.register_buffer("agg", agg)
        self.register_buffer("w", w)
        self.cheb_bounds = tuple(float(v) for v in cheb_bounds)
        self.nc = int(nc)
        self.sa_c = float(sa_c)
        self.blk = int(blk)
        self.blk_nd = blk_nd
        rows = None
        if agg is not None and not self.blk and blk_nd is None:
            rows = torch.from_numpy(_segment_rows(agg.cpu().numpy(), self.nc)).to(agg.device)
        self.register_buffer("agg_rows", rows)

    def _op(self, role):
        cls, fields, static = self._ops[role]
        return cls(**static, **{f: getattr(self, f"{role}_{f}") for f in fields})

    @property
    def A(self):
        return self._op("A")

    @property
    def P(self) -> CsrMatrix:
        return self._op("P")

    @property
    def R(self) -> CsrMatrix:
        return self._op("R")


class AmgHierarchy(nn.Module):
    """Static SA hierarchy: ``levels[0]`` is the fine level, the coarsest is
    solved by the dense inverse ``coarse_inv``.  ``setup_s`` holds
    ``build_amg_hierarchy``'s host-clock seconds by phase (empty
    otherwise)."""

    def __init__(self, levels, coarse_inv: torch.Tensor, smoother: str, pre: int, post: int,
                 omega: float):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.smoother = smoother
        self.pre = pre
        self.post = post
        self.omega = omega
        self.setup_s = {}

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1


# ---------------------------------------------------------------------------
# host-side setup
# ---------------------------------------------------------------------------


def _strength_graph(A: sp.csr_matrix, theta: float) -> sp.csr_matrix:
    """Symmetric strength of connection: keep ``|a_ij| >= theta *
    sqrt(|a_ii a_jj|)`` plus the diagonal; ``theta=0`` keeps every
    nonzero."""
    if theta <= 0.0:
        return A
    d = np.sqrt(np.abs(A.diagonal()))
    coo = A.tocoo()
    keep = np.abs(coo.data) >= theta * d[coo.row] * d[coo.col]
    keep |= coo.row == coo.col
    return sp.csr_matrix(
        (coo.data[keep], (coo.row[keep], coo.col[keep])), shape=A.shape
    )


def _infer_grid(
    n: int, offsets, max_extent: int = 3, min_pitch: int = 8, max_dims: int = 3
) -> Optional[Tuple[int, ...]]:
    """Recover a row-major tensor-grid shape (outermost first) from a banded
    offset set, or ``None``.  Offsets of a grid stencil are ``sum_k d_k *
    pitch_k`` with small reaches ``|d_k| <= max_extent``; every candidate
    pitch near the first jump offset that divides ``n`` is scored by the
    total ``|dx|`` of the decompositions and the least wins; ``min_pitch``
    rejects narrow false positives."""
    pos = sorted(int(o) for o in offsets if int(o) > 0)
    if not pos or n <= 1:
        return None
    jumps = [o for o in pos if o > max_extent]
    if not jumps:
        return (n,)  # pure 1-D stencil
    cands = sorted(
        {jumps[0] + d for d in range(-max_extent, max_extent + 1)}
        - set(range(min_pitch))
    )
    best = None  # (score, grid)
    for p in cands:
        if n % p:
            continue
        rest = set()
        ok = True
        score = 0
        for o in pos:
            dx = ((o + max_extent) % p) - max_extent
            if abs(dx) > max_extent:
                ok = False
                break
            score += abs(dx)
            r = (o - dx) // p
            if r:
                rest.add(r)
        if not ok:
            continue
        if not rest or max(rest) <= max_extent:
            grid = (n // p, p)  # 2-D: all row-jumps within reach
        elif max_dims > 2:
            sub = _infer_grid(
                n // p, sorted(rest), max_extent, min_pitch, max_dims - 1
            )
            if sub is None or len(sub) > max_dims - 1:
                continue
            grid = sub + (p,)
        else:
            continue
        if best is None or score < best[0]:
            best = (score, grid)
    return best[1] if best is not None else None


def _aggregate_python(indptr, indices, data) -> Tuple[np.ndarray, int]:
    """Vanek's three passes as a Python loop: the twin of
    ``native.aggregate`` (``csrkit_aggregate``)."""
    n = len(indptr) - 1
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    for i in range(n):  # pass 1
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        nbrs = nbrs[nbrs != i]
        if (agg[nbrs] == -1).all():
            agg[i] = n_agg
            agg[nbrs] = n_agg
            n_agg += 1
    for i in range(n):  # pass 2
        if agg[i] != -1:
            continue
        sl = slice(indptr[i], indptr[i + 1])
        nbrs, vals = indices[sl], data[sl]
        m = (nbrs != i) & (agg[nbrs] != -1)
        if m.any():
            agg[i] = agg[nbrs[m][np.argmax(vals[m])]]
    for i in range(n):  # pass 3
        if agg[i] != -1:
            continue
        nbrs = indices[indptr[i] : indptr[i + 1]]
        grp = nbrs[agg[nbrs] == -1]
        agg[i] = n_agg
        agg[grp] = n_agg
        n_agg += 1
    return agg, n_agg


def _aggregate(S: sp.csr_matrix, impl: str = "native") -> Tuple[np.ndarray, int]:
    """Greedy aggregation over the strength graph (Vanek's three passes).

    Pass 1 seeds an aggregate around every node whose strong neighbourhood
    is untouched; pass 2 attaches leftovers to their most strongly
    connected aggregate; pass 3 groups what remains into fresh aggregates.
    Returns (aggregate id per node, number of aggregates).  ``impl="native"``
    runs ``native.aggregate`` (the host kit, built by
    ``ops._build.build_host``; a failed build raises, and only where there
    is no host compiler does the Python loop run), ``"python"`` the loop
    it is tested against."""
    from conjugategradient_tpu_torch import native

    n = S.shape[0]
    indptr, indices, data = S.indptr, S.indices, np.abs(S.data)
    if impl == "python":
        return _aggregate_python(indptr, indices, data)
    if impl != "native":
        raise ValueError(f"unknown impl {impl!r}")
    ip = np.ascontiguousarray(indptr, np.int32)
    ix = np.ascontiguousarray(indices, np.int32)
    ad = np.ascontiguousarray(data, np.float64)
    if ip.shape != (n + 1,) or ip[0] != 0 or ip[-1] != ix.size or ad.size != ix.size:
        raise ValueError("malformed strength graph: indptr, indices and data disagree")
    if ix.size and (ix.min() < 0 or ix.max() >= n):
        raise ValueError("malformed strength graph: a column index is out of range")
    out = native.aggregate(ip, ix, ad)
    return _aggregate_python(indptr, indices, data) if out is None else out


def _tentative(agg: np.ndarray, n_agg: int, z: np.ndarray) -> sp.csr_matrix:
    """Tentative prolongator: column j = the near-null candidate restricted
    to aggregate j, normalised (P0^T P0 = I)."""
    nrm = np.sqrt(np.bincount(agg, weights=z * z, minlength=n_agg))
    nrm[nrm == 0.0] = 1.0
    n = agg.shape[0]
    return sp.csr_matrix(
        (z / nrm[agg], (np.arange(n), agg)), shape=(n, n_agg)
    )


def _lam_max_scaled(A: sp.csr_matrix, iters: int = 30) -> float:
    """Host power iteration for lam_max(D^{-1}A) (+10% margin), the
    convention of ``eigen.scaled_spectrum_bounds``."""
    inv_d = 1.0 / A.diagonal()
    rng = np.random.default_rng(0)
    v = rng.standard_normal(A.shape[0])
    v /= np.linalg.norm(v)
    lam = 1.0
    for _ in range(iters):
        w = inv_d * (A @ v)
        lam = float(np.linalg.norm(w))
        if lam == 0.0:
            return 1.0
        v = w / lam
    return 1.1 * lam


def _to_device_csr(S: sp.csr_matrix, dtype, device="cpu") -> CsrMatrix:
    return from_scipy(S.tocsr()).device_put(dtype, device)


def _to_device_level_op(
    S: sp.csr_matrix, dtype, layout: str, max_blowup: float, grid=None, device="cpu"
):
    """Square level operator -> device container: DIA when the diagonal
    storage blowup allows (``load_matrix_market``'s rule), relaid out onto
    ``grid`` as a stencil (const-detected) when ``grid`` is given and the
    offsets decompose onto it; else CSR.  ``layout="csr"`` keeps CSR."""
    if layout == "auto":
        csr_host = S.tocsr()
        coo = csr_host.tocoo()
        diags = np.unique(coo.col.astype(np.int64) - coo.row)
        n = csr_host.shape[0]
        if len(diags) * n <= max_blowup * max(csr_host.nnz, 1):
            dia = csr_to_dia(
                from_scipy(csr_host), offsets=tuple(int(o) for o in diags)
            )
            if grid is not None:
                try:
                    st = dia_to_stencil(dia, tuple(grid))
                except ValueError:
                    st = None  # offsets don't decompose / seam wraps nonzero
                if st is not None:
                    return stencil_to_const(st) or st.device_put(dtype, device)
            return dia.device_put(dtype, device)
    return _to_device_csr(S, dtype, device)


def _np_dtype(dtype):
    """A numpy or torch dtype as a numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def build_amg_hierarchy(
    A,
    theta: float = 0.0,
    near_null: Optional[np.ndarray] = None,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 200,
    max_levels: int = 12,
    min_coarsen: float = 0.9,
    smooth_prolongator="auto",
    dtype=None,
    layout: str = "auto",
    max_blowup: float = 3.0,
    use_pallas="auto",
    aggregation: str = "auto",
    blk: int = 4,
    infer_grid: bool = True,
    device=None,
) -> AmgHierarchy:
    """Set up a smoothed-aggregation hierarchy from any container of
    ``core.formats`` or ``scipy.sparse`` matrix, and place it on ``device``
    (``None``: the card when there is one).

    The JAX package's build, decision for decision.  ``near_null``: the
    algebraically smooth candidate (default the constant vector).
    Coarsening stops at ``max_coarse`` unknowns, ``max_levels``, or when a
    level fails to shrink below ``min_coarsen * n``.  ``aggregation="auto"``
    picks N-D cubes (edge 3) when ``_infer_grid`` finds a tensor grid that
    the operator's row seams confirm, 1-D strips of ``blk`` rows on a
    symmetric band, else greedy; ``"blocked"`` always means the strips,
    ``"greedy"`` always greedy; ``infer_grid=False`` turns the cubes off.
    ``smooth_prolongator="auto"`` smooths iff the fine operator is
    symmetric.  Host bounds, P and ``coarse_inv`` are fp64 and cast to
    ``dtype`` (default: the matrix's) where the JAX package casts.
    ``use_pallas`` is kept for parity and changes nothing.

    ``setup_s`` on the result splits the host-clock seconds into
    ``symmetry``, ``grid`` (inference and the seam check), ``aggregate``,
    ``lam_max``, ``prolongator`` (P0, P and the weights), ``level_op`` (the
    relayouts), ``transfers`` (P and R as CSR), ``galerkin``,
    ``coarse_inv`` and ``upload`` (placing the hierarchy on ``device``,
    synchronised).
    """
    setup = dict.fromkeys(("symmetry", "grid", "aggregate", "lam_max", "prolongator", "level_op",
                           "transfers", "galerkin", "coarse_inv", "upload"), 0.0)
    t0 = time.perf_counter()
    A_h = (A if sp.issparse(A) else to_scipy(to_host(A))).tocsr()
    dt = _np_dtype(dtype) if dtype is not None else np.asarray(A_h.data).dtype
    z = np.ones(A_h.shape[0]) if near_null is None else np.asarray(near_null, np.float64)
    if z.shape != (A_h.shape[0],):
        raise ValueError(f"near_null must be ({A_h.shape[0]},), got {z.shape}")

    if aggregation not in ("auto", "greedy", "blocked"):
        raise ValueError(f"unknown aggregation {aggregation!r}")

    def _bandable(S):
        coo = S.tocoo()
        diags = np.unique(coo.col.astype(np.int64) - coo.row)
        return len(diags) * S.shape[0] <= max_blowup * max(S.nnz, 1)

    def _has_offdiag(S):
        coo = S.tocoo()
        off = coo.data[coo.row != coo.col]
        return off.size > 0 and np.abs(off).max() > 1e-12 * np.abs(S.data).max(initial=1.0)

    levels = []

    def _sym_of(S):
        d_asym = (S - S.T).tocoo()
        return bool(
            np.abs(d_asym.data).max(initial=0.0)
            <= 1e-12 * np.abs(S.data).max(initial=0.0)
        )

    sym_fine = _sym_of(A_h)  # computed once; reused by auto + first level
    if smooth_prolongator == "auto":
        smooth_prolongator = sym_fine
    smooth_prolongator = bool(smooth_prolongator)
    setup["symmetry"] += time.perf_counter() - t0

    grid_nd = None  # inferred tensor grid, tracked down the ND-blocked levels
    nd_checked = False
    prebuilt_st = None  # level-0 stencil validated during grid inference
    while A_h.shape[0] > max_coarse and len(levels) < max_levels - 1:
        t0 = time.perf_counter()
        diag = A_h.diagonal()
        if np.any(diag <= 0):
            raise ValueError(
                "non-positive diagonal; not compatible with Jacobi scaling "
                "(for symmetric indefinite systems use minres with a "
                "different preconditioner)"
            )
        n_lvl = A_h.shape[0]
        sym = sym_fine if not levels else _sym_of(A_h)
        # blocked-eligible: symmetric smoothed-SA levels, or any unsmoothed
        # level (composition transfers are exact with sa_c = 0)
        want_blocked = aggregation == "blocked" or (
            aggregation == "auto"
            and ((sym and smooth_prolongator) or not smooth_prolongator)
            and _bandable(A_h)
            and _has_offdiag(A_h)
        )
        t1 = time.perf_counter()
        setup["symmetry"] += t1 - t0
        blk_nd_lvl = None
        if (want_blocked and infer_grid and not nd_checked
                and aggregation != "blocked"):
            nd_checked = True
            coo0 = A_h.tocoo()
            diags0 = np.unique(coo0.col.astype(np.int64) - coo0.row)
            g_found = _infer_grid(n_lvl, diags0)
            if g_found is not None and len(g_found) >= 2:
                # a genuine grid stencil has exact zeros at every row seam:
                # a divisible-but-wrong pitch fails dia_to_stencil here
                try:
                    dia0 = csr_to_dia(
                        from_scipy(A_h.tocsr()),
                        offsets=tuple(int(o) for o in diags0),
                    )
                    st0 = dia_to_stencil(dia0, tuple(g_found), copy=False)
                    grid_nd = g_found
                    prebuilt_st = stencil_to_const(st0) or st0.device_put(dt, "cpu")
                except ValueError:
                    pass
        blocked = want_blocked and (
            grid_nd is not None
            or (sym and smooth_prolongator)
            or aggregation == "blocked"
        )
        t2 = time.perf_counter()
        setup["grid"] += t2 - t1
        if blocked and grid_nd is not None:
            blks = tuple(3 if g >= 3 else 1 for g in grid_nd)
            cgrid = tuple(-(-g // b) for g, b in zip(grid_nd, blks))
            coords = []
            rem = np.arange(n_lvl, dtype=np.int64)
            for g in reversed(grid_nd):
                coords.append(rem % g)
                rem //= g
            coords = coords[::-1]
            agg = np.zeros(n_lvl, dtype=np.int64)
            for c, b_ax, cg in zip(coords, blks, cgrid):
                agg = agg * cg + c // b_ax
            n_agg = int(np.prod(cgrid))
            blk_nd_lvl = (tuple(grid_nd), blks)
        elif blocked:
            agg = np.arange(n_lvl, dtype=np.int64) // int(blk)
            n_agg = int(-(-n_lvl // int(blk)))
        else:
            agg, n_agg = _aggregate(_strength_graph(A_h, theta))
        t3 = time.perf_counter()
        setup["aggregate"] += t3 - t2
        if n_agg >= min_coarsen * A_h.shape[0]:
            break  # aggregation stagnated; stop coarsening here
        lam_max = _lam_max_scaled(A_h)
        t4 = time.perf_counter()
        setup["lam_max"] += t4 - t3
        P0 = _tentative(agg, n_agg, z)
        if smooth_prolongator:
            Dinv = sp.diags(1.0 / diag)
            P = (P0 - (_SA_W / lam_max) * (Dinv @ (A_h @ P0))).tocsr()
        else:
            P = P0.tocsr()
        # composition-form transfers (exact without symmetry when unsmoothed)
        sym = not smooth_prolongator or sym
        w_tent = np.asarray(P0[np.arange(A_h.shape[0]), agg]).ravel()
        t5 = time.perf_counter()
        setup["prolongator"] += t5 - t4
        if (prebuilt_st is not None and sym and blk_nd_lvl is not None
                and layout == "auto"):
            A_dev_lvl = prebuilt_st  # level 0, validated during inference
        else:
            A_dev_lvl = _to_device_level_op(
                A_h, dt, layout, max_blowup,
                grid=blk_nd_lvl[0] if (blk_nd_lvl is not None and sym) else None,
            )
        prebuilt_st = None
        # stencil levels run the cycle grid-shaped: their elementwise
        # carriers are stored grid-shaped too
        lvl_shape = (A_dev_lvl.grid if isinstance(A_dev_lvl, (StencilMatrix, ConstStencilMatrix))
                     else (-1,))
        t6 = time.perf_counter()
        setup["level_op"] += t6 - t5
        P_dev, R_dev = _to_device_csr(P, dt), _to_device_csr(P.T, dt)
        t7 = time.perf_counter()
        setup["transfers"] += t7 - t6
        levels.append(
            AmgLevel(
                A=A_dev_lvl,
                P=P_dev,
                R=R_dev,
                inv_diag=torch.from_numpy((1.0 / diag).astype(dt).reshape(lvl_shape)),
                cheb_bounds=(0.25 * lam_max, lam_max),
                agg=torch.from_numpy(agg.astype(np.int32)) if sym else None,
                w=torch.from_numpy(w_tent.astype(dt).reshape(lvl_shape)) if sym else None,
                nc=int(n_agg),
                sa_c=float(_SA_W / lam_max) if smooth_prolongator else 0.0,
                blk=int(blk) if (blocked and sym and blk_nd_lvl is None) else 0,
                blk_nd=blk_nd_lvl if sym else None,
            )
        )
        # a level that did not aggregate in cubes ends the grid lineage
        grid_nd = cgrid if blk_nd_lvl is not None else None
        t8 = time.perf_counter()
        A_h = (P.T @ (A_h @ P)).tocsr()
        z = np.asarray(P0.T @ z)
        setup["galerkin"] += time.perf_counter() - t8

    t0 = time.perf_counter()
    coarse_inv = torch.from_numpy(np.linalg.inv(A_h.toarray().astype(np.float64)).astype(dt))
    h = AmgHierarchy(levels, coarse_inv, smoother, pre, post, omega)
    t1 = time.perf_counter()
    h = h.to(default_device(device))
    if h.coarse_inv.device.type == "cuda":
        torch.cuda.synchronize(h.coarse_inv.device)
    setup.update(coarse_inv=t1 - t0, upload=time.perf_counter() - t1)
    h.setup_s = setup
    return h


# ---------------------------------------------------------------------------
# device-side cycle
# ---------------------------------------------------------------------------


def _smooth(h: AmgHierarchy, lvl: AmgLevel, op, b, x, sweeps: int, invd):
    if sweeps <= 0:
        return x
    if h.smoother == "chebyshev":
        lo, hi = lvl.cheb_bounds
        return chebyshev_smooth(op, invd, b, x, sweeps, hi, lo)
    return jacobi_smooth(op, invd, b, x, sweeps, h.omega)


def _transfers(lvl: AmgLevel, A, op, invd, w, grid_mode: bool):
    """(restrict, prolong) of a level in its composition form, or the CSR
    products of R and P where it has none."""
    c = lvl.sa_c

    def smooth_r(v):  # R v = P0^T (v - c A D^{-1} v)
        return v - c * op(invd * v) if c else v

    def smooth_p(t):  # P e = t - c D^{-1} A t,  t = P0 e
        return t - c * (invd * op(t)) if c else t

    if lvl.blk_nd is not None:
        # N-D cubes: pad and sum over the block axes; repeat per axis and crop
        grid_l, blks = lvl.blk_nd
        cgrid = tuple(-(-g // b_) for g, b_ in zip(grid_l, blks))
        padded = tuple(cc * b_ for cc, b_ in zip(cgrid, blks))
        inter = tuple(x for cc, b_ in zip(cgrid, blks) for x in (cc, b_))
        blk_axes = tuple(range(1, 2 * len(cgrid), 2))
        crop = tuple(slice(0, g) for g in grid_l)

        def restrict(v):  # grid-shaped in (grid_mode) -> flat coarse out
            t = w * smooth_r(v)
            t = t if grid_mode else t.reshape(grid_l)
            if padded != tuple(grid_l):
                tp = t.new_zeros(padded)
                tp[crop] = t
                t = tp
            return t.reshape(inter).sum(dim=blk_axes).reshape(-1)

        def prolong(e):  # flat coarse in -> grid-shaped out (grid_mode)
            t = e.reshape(cgrid)
            for ax, b_ in enumerate(blks):
                if b_ > 1:
                    t = torch.repeat_interleave(t, b_, dim=ax)
            t = t[crop]
            return smooth_p((t if grid_mode else t.reshape(-1)) * w)

        return restrict, prolong
    if lvl.blk:
        n_lvl, nc, blk = A.n, lvl.nc, lvl.blk
        pad = nc * blk - n_lvl

        def restrict(v):
            t = w * smooth_r(v)
            if pad:
                t = torch.cat([t, t.new_zeros(pad)])
            return t.reshape(nc, blk).sum(dim=1)

        def prolong(e):
            return smooth_p(torch.repeat_interleave(e, blk)[:n_lvl] * w)

        return restrict, prolong
    if lvl.agg is not None:
        # a fixed-order segment sum: gather each aggregate's rows (ascending,
        # padded with an appended zero) and sum along them; no atomics
        def restrict(v):
            t = w * smooth_r(v)
            return torch.cat([t, t.new_zeros(1)])[lvl.agg_rows].sum(dim=1)

        def prolong(e):
            return smooth_p(w * e[lvl.agg])

        return restrict, prolong
    return partial(spmv_csr, lvl.R), partial(spmv_csr, lvl.P)


def _coarse_solve(h: AmgHierarchy, b: torch.Tensor) -> torch.Tensor:
    with no_tf32():
        return torch.matmul(h.coarse_inv, b)


def amg_vcycle(h: AmgHierarchy, b: torch.Tensor, level: int = 0, gamma: int = 1,
               finest: bool = True) -> torch.Tensor:
    """One V- (``gamma=1``) or W- (``gamma=2``) cycle for ``A_level e = b``
    from a zero guess, on ``b``'s device.  Inter-level vectors are flat
    ``(n,)``; a stencil level with cube transfers runs grid-shaped inside,
    its ``inv_diag`` and ``w`` grid-shaped, one reshape at entry and exit.
    A W-cycle repeats the coarse correction on every level but the finest;
    ``finest=False`` says that ``h``'s level 0 is not the finest (a
    replicated tail below sharded levels), so it repeats there too."""
    if level == len(h.levels):
        return _coarse_solve(h, b)
    lvl = h.levels[level]
    A = lvl.A
    is_st = isinstance(A, (StencilMatrix, ConstStencilMatrix))
    grid_mode = is_st and lvl.blk_nd is not None
    if is_st and not grid_mode:
        op = lambda v: spmv(A, v.reshape(A.grid)).reshape(-1)
    else:
        op = partial(spmv, A)
    tgt = A.grid if grid_mode else (-1,)
    invd = lvl.inv_diag.reshape(tgt)
    w = None if lvl.w is None else lvl.w.reshape(tgt)
    restrict, prolong = _transfers(lvl, A, op, invd, w, grid_mode)
    bl = b.reshape(A.grid) if grid_mode else b
    x = _smooth(h, lvl, op, bl, torch.zeros_like(bl), h.pre, invd)
    for _ in range(gamma if level > 0 or not finest else 1):
        rc = restrict(bl - op(x))
        ec = amg_vcycle(h, rc, level + 1, gamma)
        x = x + prolong(ec)
    x = _smooth(h, lvl, op, bl, x, h.post, invd)
    return x.reshape(-1) if grid_mode else x


def amg_preconditioner(h: AmgHierarchy, gamma: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """M(r) = one SA cycle, SPD by construction (R = P^T, symmetric
    smoothing), for ``cg_solve(..., M=...)``.  An ``(n, k)`` block runs one
    cycle per column (contiguous columns of a ``(k, n)`` copy), each
    column what the JAX package's vmapped cycle computes."""

    def M(r):
        if r.ndim == 2:
            rk = r.T.contiguous()
            return torch.stack([amg_vcycle(h, rk[j], gamma=gamma) for j in range(rk.shape[0])],
                               dim=1)
        return amg_vcycle(h, r, gamma=gamma)

    return M


def amg_cg_solve(
    A,
    b,
    x0=None,
    policy=None,
    hierarchy: Optional[AmgHierarchy] = None,
    gamma: int = 1,
    dtype=None,
    device=None,
    **setup_kw,
):
    """Smoothed-aggregation-preconditioned CG: MGCG for matrices with no
    grid.  Builds the hierarchy on ``device`` (``None``: the card when
    there is one) unless ``hierarchy`` is given, and solves where the
    hierarchy lies.  Returns ``(CGResult, AmgHierarchy)`` so the hierarchy
    can be reused across solves with the same matrix."""
    from conjugategradient_tpu_torch.solvers.cg import cg_solve
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    if sp.issparse(A):
        A = from_scipy(A)
    if dtype is None:
        dtype = b.dtype if torch.is_tensor(b) else np.asarray(b).dtype
    h = hierarchy
    if h is None:
        h = build_amg_hierarchy(A, dtype=dtype, device=device, **setup_kw)
    dev = h.coarse_inv.device
    A_dev = A.device_put(dtype, dev) if hasattr(A, "device_put") else A
    b_dev = place(b, torch_dtype(dtype), dev)
    x0_dev = None if x0 is None else place(x0, torch_dtype(dtype), dev)
    res = cg_solve(A_dev, b_dev, x0_dev, policy, M=amg_preconditioner(h, gamma))
    return res, h
