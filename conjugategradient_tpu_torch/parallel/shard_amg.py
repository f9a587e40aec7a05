"""Distributed algebraic multigrid: row-sharded smoothed-aggregation levels
over a mesh.

The port of ``conjugategradient_tpu/parallel/shard_amg.py``.  ``precond.amg``
builds SA hierarchies for matrices with no grid (Matrix Market files,
permuted meshes, graph Laplacians); here every level large enough is
row-block-sharded and the cycle runs as the ``M`` of the sharded Krylov
loops (``sharded_cg_loop`` and ``parallel.shard_nonsym``'s BiCGStab, GMRES,
FGMRES and MINRES), on the single-controller mesh of ``parallel.mesh``:

- the host setup turns each level's operator (the port's levels may be
  const or variable stencils, DIA or CSR) and its prolongator into host CSR
  and pads them with identity rows to shard divisibility (decoupled rows,
  ``x = b = 0`` there: A gains unit diagonal entries, P and R zero rows and
  columns, so the padded entries stay exactly zero through smoothing,
  transfer and the Krylov recurrence);
- each level operator, restriction ``R = P^T`` and prolongation ``P`` is a
  rectangular per-shard block (``_rect_shard_arrays``, the JAX package's
  layout: rows in this level's partition, columns indexing a vector in the
  other level's), its columns rebased into the window an exact-hop
  ``halo.ring_gather`` collects (hops from each shard's column range), or
  global where that window would cover most of the ring (one
  ``all_gather``);
- the levels below ``min_local`` rows a shard form a replicated tail: the
  restricted residual is gathered once onto the first shard's device,
  ``precond.amg.amg_vcycle`` runs there once (its stencil levels on kernels
  #1 and #3, DIA levels on #4, CSR levels on cuSPARSE), and each shard
  takes its rows of the correction back.

The JAX package computes the per-shard rectangular products with XLA
gathers and segment sums, outside its Pallas kernels; the port runs them as
``parallel.sharded_general`` runs CSR shards: each shard's block a device
``CsrMatrix`` applied to the gathered window by ``ops.spmv.spmv_csr``
(cuSPARSE on the card).  Grid-structured systems should keep the geometric
carriers (``parallel.shard_mgcg``, ``parallel.gspmd``), whose halos are
O(bandwidth) by construction.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from conjugategradient_tpu_torch.core.formats import to_host, torch_dtype
from conjugategradient_tpu_torch.core.io import from_scipy, to_scipy
from conjugategradient_tpu_torch.core.partition import RowBlockPartition, hops_from_ranges
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import spmv, spmv_csr
from conjugategradient_tpu_torch.parallel.halo import ring_gather
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, all_gather, make_mesh
from conjugategradient_tpu_torch.parallel.sharded_cg import _shards
from conjugategradient_tpu_torch.parallel.sharded_general import _blocks
from conjugategradient_tpu_torch.precond.amg import (
    AmgHierarchy,
    AmgLevel,
    _np_dtype,
    amg_vcycle,
    build_amg_hierarchy,
)
from conjugategradient_tpu_torch.precond.smoothers import chebyshev_smooth, jacobi_smooth
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the Krylov bases of the sharded AMG
METHODS = ("cg", "bicgstab", "gmres", "fgmres", "minres")


# ---------------------------------------------------------------------------
# host setup: pad, partition, rebase
# ---------------------------------------------------------------------------


def _pad_scipy(S: sp.csr_matrix, mr: int, mc: int, unit_diag: bool) -> sp.csr_matrix:
    """Grow a scipy CSR to (mr, mc); ``unit_diag`` puts 1.0 on the appended
    rows' diagonal (identity-row padding of a square operator)."""
    nr, _ = S.shape
    coo = S.tocoo()
    rows, cols, data = coo.row, coo.col, coo.data
    if unit_diag and mr > nr:
        extra = np.arange(nr, mr)
        rows = np.concatenate([rows, extra])
        cols = np.concatenate([cols, extra])
        data = np.concatenate([data, np.ones(mr - nr, dtype=data.dtype)])
    return sp.csr_matrix((data, (rows, cols)), shape=(mr, mc))


def _rect_shard_arrays(S: sp.csr_matrix, num: int):
    """Per-shard padded ``(data, cols, rows)`` blocks of a rectangular CSR
    whose rows split over ``num`` shards and whose columns index a vector
    split over ``num`` shards (both shard-divisible), the JAX package's
    arrays.  Returns ``(data, cols, rows, hops, use_allgather)``: columns in
    ring-window coordinates (``col - col_off + hops * nc_local``) unless
    the exact windows would cover most of the ring, then global (the
    consumer all-gathers).  Padding entries: data 0, row ``nr_local - 1``,
    an in-range column."""
    nr, nc = S.shape
    if nr % num or nc % num:
        raise ValueError(f"({nr}, {nc}) does not split into {num} shards")
    nr_local, nc_local = nr // num, nc // num
    row_part = RowBlockPartition.equal(nr, num)
    col_part = RowBlockPartition.equal(nc, num)
    indptr, indices, data = S.indptr, S.indices, S.data
    row_ids = np.repeat(np.arange(nr), np.diff(indptr))

    ranges = []
    for off, cnt, coff in zip(row_part.offsets, row_part.counts, col_part.offsets):
        lo, hi = int(indptr[off]), int(indptr[off + cnt])
        if hi > lo:
            c = indices[lo:hi]
            ranges.append((int(c.min()), int(c.max())))
        else:
            ranges.append((coff, coff))
    hops = hops_from_ranges(ranges, col_part)
    use_allgather = 2 * hops + 1 >= num
    pad_col = 0 if use_allgather else hops * nc_local

    spans = [(int(indptr[o]), int(indptr[o + c])) for o, c in zip(row_part.offsets, row_part.counts)]
    nnz_max = max(1, max(hi - lo for lo, hi in spans))
    data_sh = np.zeros((num, nnz_max), dtype=data.dtype)
    cols_sh = np.full((num, nnz_max), pad_col, dtype=np.int32)
    rows_sh = np.full((num, nnz_max), nr_local - 1, dtype=np.int32)
    for s, ((lo, hi), roff, coff) in enumerate(zip(spans, row_part.offsets, col_part.offsets)):
        m = hi - lo
        data_sh[s, :m] = data[lo:hi]
        cols_sh[s, :m] = indices[lo:hi] - (0 if use_allgather else coff - hops * nc_local)
        rows_sh[s, :m] = row_ids[lo:hi] - roff
    return data_sh, cols_sh, rows_sh, hops, use_allgather


@dataclasses.dataclass(frozen=True)
class _LevelMeta:
    """A sharded level's shapes and exchange plan."""

    n_local: int  # this level's rows a shard (padded)
    nc_local: int  # the next level's rows a shard (padded; the tail's top if last)
    hops_A: int
    ag_A: bool
    hops_R: int
    ag_R: bool
    hops_P: int
    ag_P: bool
    cheb_bounds: Tuple[float, float]


class ShardedAmg(NamedTuple):
    """A hierarchy placed on a mesh: ``levels[l]`` the ``(A, R, P,
    inv_diag)`` of sharded level l (each product a ``Shards`` of device
    ``CsrMatrix`` blocks over its gathered window; ``inv_diag`` the rows'
    ``Shards``), ``metas`` their exchange plans, ``tail`` the replicated
    ``AmgHierarchy`` on the mesh's first device (its top level padded to
    the gather size) and ``n_pad`` the padded fine size."""

    levels: tuple
    metas: Tuple[_LevelMeta, ...]
    tail: AmgHierarchy
    n_pad: int


def _host_csr(M) -> sp.csr_matrix:
    """A level's operator or transfer (any container, on any device) as a
    host scipy CSR."""
    return to_scipy(to_host(M)).tocsr()


def _window(hops: int, use_ag: bool, nc_local: int, num: int) -> int:
    """The columns of a shard's block: the gathered vector, or its ring
    window of ``2 * hops + 1`` blocks."""
    return nc_local * num if use_ag else (2 * hops + 1) * nc_local


def build_sharded_amg(h: AmgHierarchy, mesh: Mesh, axis: str = "x",
                      min_local: int = 32) -> ShardedAmg:
    """Partition an SA hierarchy for ``mesh``: the levels holding at least
    ``min_local`` rows a shard are sharded (identity-padded, their
    products per-shard CSR blocks), the rest replicate in the tail.  The
    blocks are in the hierarchy's dtype."""
    mesh.one_process("the sharded AMG")
    num = mesh.shape[axis]
    dt = h.coarse_inv.dtype
    np_dt = _np_dtype(dt)
    levels_h = [(_host_csr(lvl.A), _host_csr(lvl.P), lvl.inv_diag.reshape(-1).cpu().numpy(),
                 lvl.cheb_bounds) for lvl in h.levels]

    t = 0
    while t < len(levels_h) and levels_h[t][0].shape[0] >= min_local * num:
        t += 1
    pad = lambda n: -(-n // num) * num
    sizes = [A_h.shape[0] for A_h, _, _, _ in levels_h] + [h.coarse_inv.shape[0]]
    padded = [pad(n) for n in sizes[:t + 1]] + sizes[t + 1:]

    levels, metas = [], []
    for l in range(t):
        A_h, P_h, invd, bounds = levels_h[l]
        m_l, m_c = padded[l], padded[l + 1]
        P_p = _pad_scipy(P_h, m_l, m_c, unit_diag=False)
        mats, meta = [], []
        for S, nr, nc in ((_pad_scipy(A_h, m_l, m_l, unit_diag=True), m_l, m_l),
                          (P_p.T.tocsr(), m_c, m_l), (P_p, m_l, m_c)):
            data, cols, rows, hops, ag = _rect_shard_arrays(S, num)
            mats.append(_blocks(mesh, (data.astype(np_dt), cols, rows), nr // num,
                                _window(hops, ag, nc // num, num)))
            meta += [hops, ag]
        invd_p = np.concatenate([invd, np.ones(m_l - len(invd), dtype=invd.dtype)])
        levels.append((*mats, _shards(mesh, invd_p, dt)))
        metas.append(_LevelMeta(m_l // num, m_c // num, *meta, cheb_bounds=tuple(bounds)))

    # the replicated tail, its top padded to the gather size
    dev = mesh.local_devices[0]
    m_t = padded[t]
    if t == len(levels_h):
        ci = h.coarse_inv.cpu()
        if m_t > ci.shape[0]:
            ci_p = torch.eye(m_t, dtype=ci.dtype)
            ci_p[:ci.shape[0], :ci.shape[0]] = ci
            ci = ci_p
        tail = AmgHierarchy([], ci, h.smoother, h.pre, h.post, h.omega)
    else:
        A_h, P_h, invd, bounds = levels_h[t]
        n_t = A_h.shape[0]
        P_p = _pad_scipy(P_h, m_t, P_h.shape[1], unit_diag=False)
        top = AmgLevel(from_scipy(_pad_scipy(A_h, m_t, m_t, unit_diag=True)).device_put(dt, dev),
                       from_scipy(P_p).device_put(dt, dev),
                       from_scipy(P_p.T.tocsr()).device_put(dt, dev),
                       torch.from_numpy(np.concatenate([invd, np.ones(m_t - n_t, invd.dtype)])),
                       bounds)
        tail = AmgHierarchy([top] + list(h.levels[t + 1:]), h.coarse_inv, h.smoother, h.pre,
                            h.post, h.omega)
    return ShardedAmg(tuple(levels), tuple(metas), tail.to(dev), padded[0])


def _gathered(p: Shards, hops: int, use_ag: bool) -> Shards:
    return all_gather(p) if use_ag else ring_gather(p, hops)


def _product(mat: Shards, hops: int, use_ag: bool):
    return lambda p: Shards.map(spmv_csr, mat, _gathered(p, hops, use_ag))


def _tail_cycle(tail: AmgHierarchy, b: Shards, gamma: int, finest: bool) -> Shards:
    """The replicated tail once on the first shard's device: the gathered
    residual in, each shard's rows of the correction out.  ``finest``: no
    level shards, so the tail's top is the finest level."""
    mesh = b.mesh
    with no_tf32():  # the dense coarse product in full fp32
        e = amg_vcycle(tail, b.gather(), gamma=gamma, finest=finest)
    n = b.shape[0]
    return Shards([e[i * n:(i + 1) * n].to(d) for i, d in mesh.shards()], mesh)


def make_sharded_vcycle(sh: ShardedAmg, h: AmgHierarchy, gamma: int = 1):
    """``M(r)``: the sharded SA cycle on row-sharded padded vectors, the
    ``M`` of the sharded Krylov loops.  ``gamma`` rides into the tail: its
    top repeats its own coarse correction unless it is the finest level,
    as the single-device ``amg_vcycle`` does there.  (The JAX package's
    sharded cycle repeats nothing at the tail's top, so under one sharded
    level and a tail of two or more its W-cycle is a V-cycle.)"""

    def smooth(meta, opA, invd, b, x, sweeps):
        if sweeps <= 0:
            return x
        if h.smoother == "chebyshev":
            lo, hi = meta.cheb_bounds
            return chebyshev_smooth(opA, invd, b, x, sweeps, hi, lo)
        return jacobi_smooth(opA, invd, b, x, sweeps, h.omega)

    def cyc(l: int, b: Shards) -> Shards:
        if l == len(sh.metas):
            return _tail_cycle(sh.tail, b, gamma, finest=l == 0)
        (A, R, P, invd), meta = sh.levels[l], sh.metas[l]
        opA = _product(A, meta.hops_A, meta.ag_A)
        x = smooth(meta, opA, invd, b, torch.zeros_like(b), h.pre)
        for _ in range(gamma if l > 0 else 1):
            ec = cyc(l + 1, _product(R, meta.hops_R, meta.ag_R)(b - opA(x)))
            x = x + _product(P, meta.hops_P, meta.ag_P)(ec)
        return smooth(meta, opA, invd, b, x, h.post)

    return lambda r: cyc(0, r)


def make_sharded_amg(
    h: AmgHierarchy,
    n: int,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "cg",
    axis: str = "x",
    gamma: int = 1,
    min_local: int = 32,
    restart: int = 32,
    sharded: Optional[ShardedAmg] = None,
):
    """Build the sharded AMG-preconditioned solver for an ``n``-row system.

    Returns ``(solve, sharded, n_pad)``: ``solve(b_pad, x0_pad) ->
    CGResult`` on row-sharded padded vectors (``Shards`` or global
    arrays; ``x`` the padded global solution on the mesh's first device),
    ``sharded`` the ``ShardedAmg`` (``build_sharded_amg`` of ``h`` on
    ``mesh``; pass one back to skip the host setup for another method).
    The fine operator is level 0's sharded block, or, where no level
    shards, the tail's top on the gathered vector."""
    from conjugategradient_tpu_torch.parallel.shard_nonsym import run_sharded_loop

    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    sh = sharded or build_sharded_amg(h, mesh, axis=axis, min_local=min_local)
    if sh.metas:
        meta0 = sh.metas[0]
        op = _product(sh.levels[0][0], meta0.hops_A, meta0.ag_A)
    else:
        if not sh.tail.levels:
            raise ValueError(f"system too small to distribute (n <= max_coarse and < {min_local} "
                             "rows/shard); solve single-device")
        A_top = sh.tail.levels[0].A

        def op(p: Shards) -> Shards:
            y = spmv(A_top, p.gather())
            k = p.shape[0]
            return Shards([y[i * k:(i + 1) * k].to(d) for i, d in mesh.shards()], mesh)

    M = make_sharded_vcycle(sh, h, gamma=gamma)

    def solve(b_pad, x0_pad) -> CGResult:
        b_sh = _shards(mesh, b_pad, None)
        res = run_sharded_loop(method, op, M, b_sh, _shards(mesh, x0_pad, b_sh.dtype), policy, n,
                               restart=restart)
        return dataclasses.replace(res, x=res.x.gather())

    solve.mesh_axis = axis
    return solve, sh, sh.n_pad


def sharded_amg_solve(
    A,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "cg",
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    hierarchy: Optional[AmgHierarchy] = None,
    gamma: int = 1,
    min_local: int = 32,
    restart: int = 32,
    dtype=None,
    **setup_kw,
) -> Tuple[CGResult, AmgHierarchy]:
    """Row-block-sharded AMG-preconditioned solve (``amg_cg``,
    ``amg_bicgstab``, ``amg_gmres``, ``amg_fgmres``, ``amg_minres`` over a
    mesh; every visible CUDA device by default).

    ``A``: any ``core.formats`` container or scipy sparse matrix.  The
    hierarchy (``precond.amg.build_amg_hierarchy``, Jacobi smoothing on the
    nonsymmetric bases) is built on the mesh's first device unless passed
    in, and returned for reuse.  The system is identity-padded to shard
    divisibility inside and ``x`` cut back to ``n``."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    b_h = b.detach().cpu().numpy() if torch.is_tensor(b) else np.asarray(b)
    if hierarchy is None:
        if method in ("bicgstab", "gmres", "fgmres"):
            setup_kw.setdefault("smoother", "jacobi")
        dt = _np_dtype(dtype) if dtype is not None else b_h.dtype
        hierarchy = build_amg_hierarchy(A, dtype=dt, device=mesh.local_devices[0], **setup_kw)
    h = hierarchy
    tdt = h.coarse_inv.dtype if dtype is None else torch_dtype(dtype)
    n = b_h.shape[0]
    solve, _, n_pad = make_sharded_amg(h, n, mesh, policy, method=method, axis=axis, gamma=gamma,
                                       min_local=min_local, restart=restart)
    b_pad = torch.zeros(n_pad, dtype=tdt)
    b_pad[:n] = torch.from_numpy(b_h.astype(np.float64)).to(tdt)
    x0_pad = torch.zeros(n_pad, dtype=tdt)
    if x0 is not None:
        x0_h = x0.detach().cpu() if torch.is_tensor(x0) else torch.from_numpy(np.asarray(x0))
        x0_pad[:n] = x0_h.to(tdt)
    res = solve(b_pad, x0_pad)
    if n_pad != n:
        res = dataclasses.replace(res, x=res.x[:n])
    return res, h
