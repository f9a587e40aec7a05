"""Explicit-collective MGCG: the V-cycle itself sharded over a mesh.

The port of ``conjugategradient_tpu/parallel/shard_mgcg.py``, the JAX
package's distributed form of MGCG, on the single-controller mesh of
``parallel.mesh`` (a mesh may repeat a device: four shards on one card):

- each *sharded* level runs on blocks of its grid: axis-0 row blocks over
  a 1-D mesh, 2-D blocks of axes 0 and 1 over a 2-D mesh; its stencil
  product is ``parallel.halo.HaloStencil``: one ``ppermute`` pair of halo
  slabs a sharded axis, kernel #3 on each shard's extended block
  (``spmv_stencil_cuda``, tuned or wide by ``var_route``; its twin on a CPU
  tensor).  Constant-coefficient levels are expanded to legs
  (``const_to_stencil``'s values, built on each shard's device), so the
  ring's wraparound at the global edges lands on structural zeros;
- the smoothers (Chebyshev, Jacobi, red-black Gauss-Seidel) are the
  single-device ones over the sharded operator: they run unfused (kernel
  #2 smooths only the replicated tail's 3-D constant levels, as the JAX
  package fuses nothing on sharded levels); rbgs masks are parity of
  global indices, so each shard takes its block of the host mask;
- aggregation transfers are shard-local (a shard whose local extents are
  even owns whole aggregates), semicoarsening that leaves the sharded axes
  alone is too, and the hybrid fw/cell-centred transfers exchange one
  boundary element along each sharded axis per restrict or prolong (a
  1-element ``ppermute`` pair an axis, zeroed at the global boundary);
- the levels below ``n_sharded`` are the replicated tail: the restricted
  residual is gathered once onto the first shard's device, the
  single-device ``precond.multigrid.v_cycle`` runs there once (kernels #1,
  #2, #3 and the dense coarse inverse), and each shard gets its block of
  the correction back.  On four shards of one card the coarse cycle runs
  once, not four times; on distinct cards the result is the same.  Over
  processes the gather is collective, every process runs the tail on its
  first device (the same inputs, the same bits) and keeps its own blocks.

The outer loop is ``parallel.sharded_cg.sharded_cg_loop`` (``variant``
``cg``, ``cg1`` or ``pipelined``) over its own ``HaloStencil`` of the fine
level, whose search direction lives in the product's halo buffer.
``make_shard_vcycle`` is the cycle alone, the right preconditioner that
the sharded nonsymmetric loops take (``parallel.gspmd.make_gspmd_mg_nonsym``).

Sharding constraint, as in the JAX package: a level shards where each
sharded axis divides the mesh with an even local extent, its halo fits
one hop, and its transfer is ``agg`` or ``hyb``, or ``semi*`` leaving the
sharded axes alone (``_shardable``); odd 2^k - 1 grids take
``parallel.gspmd``.  A level where any sharded axis stops dividing goes
to the replicated tail (GSPMD would replicate only that axis; the result
is the same to reduction rounding).  Left out:
the JAX factory's ``lower_args``/``jitted`` (the compiled program's
handles for HLO inspection); the solve carries ``plan`` instead (the split,
each sharded level's local extent and halo, the tail's grids and the
bytes a cycle moves between shards).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix, torch_dtype
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.parallel.halo import HaloStencil
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    make_mesh,
    ppermute,
    replicate,
    shard_blocks,
)
from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_loop
from conjugategradient_tpu_torch.precond import transfer
from conjugategradient_tpu_torch.precond.amg import _np_dtype
from conjugategradient_tpu_torch.precond.multigrid import (
    _SA_W,
    MgHierarchy,
    _semi_mask,
    build_hierarchy,
    v_cycle,
)
from conjugategradient_tpu_torch.precond.smoothers import (
    chebyshev_smooth,
    jacobi_smooth,
    redblack_gs_smooth,
    redblack_gs_smooth_reversed,
)
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

GridShape = Tuple[int, ...]


# ---------------------------------------------------------------------------
# transfers on the trailing d (grid) dims of a block: a vector's (n0, *rest)
# or k columns' (k, n0, *rest); axis 0 of the grid is dim -d
# ---------------------------------------------------------------------------


def _per_axis(v: torch.Tensor, fns) -> torch.Tensor:
    """``fns[ax]`` (a function of the last axis, or ``None``) along grid
    axis ax of the trailing ``len(fns)`` dims, axis by axis in order."""
    d = len(fns)
    for ax, fn in enumerate(fns):
        if fn is not None:
            v = transfer._along(fn, v, ax - d)
    return v.contiguous()


def _restrict_agg(v, d: int):
    return _per_axis(v, [transfer._restrict_agg_axis] * d)


def _prolong_agg(e, fine: GridShape):
    return _per_axis(e, [lambda t, n=n: transfer._prolong_agg_axis(t, n) for n in fine])


def _restrict_partial(v, mask):
    kinds = transfer.partial_kinds(tuple(v.shape[-len(mask):]), mask)
    return _per_axis(v, [None if k == "id" else transfer._RESTRICT[k] for k in kinds])


def _prolong_partial(e, fine: GridShape, mask):
    kinds = transfer.partial_kinds(tuple(fine), mask)
    return _per_axis(e, [None if k == "id" else (lambda t, k=k, n=n: transfer._PROLONG[k](t, n))
                         for k, n in zip(kinds, fine)])


def _restrict_fw(v, d: int):
    return _per_axis(v, [transfer._restrict_axis] * d)


def _prolong_fw(e, fine: GridShape):
    return _per_axis(e, [lambda t, n=n: transfer._prolong_axis(t, n) for n in fine])


def _cc_halo(v: Shards, d: int, ax: int = 0) -> Tuple[Shards, Shards]:
    """(left, right): the neighbours' edge slabs (one element along grid
    axis ``ax``, a sharded axis: axis 0 over the flat ring of a 1-D mesh,
    axis ``ax`` along the same axis of a 2-D one), zeroed at the global
    boundary as the unsharded cell-centred transfers pad with zeros."""
    mesh = v.mesh
    dim = ax - d
    pos = [mesh.coords(i)[ax] for i in mesh.owned]
    num = mesh.dims[ax]
    if num == 1:
        z = Shards.map(lambda t: torch.zeros_like(t.narrow(dim, 0, 1)), v)
        return z, z
    along = None if mesh.ndim == 1 else ax
    left = ppermute(Shards.map(lambda t: t.narrow(dim, t.shape[dim] - 1, 1), v), 1, along)
    right = ppermute(Shards.map(lambda t: t.narrow(dim, 0, 1), v), -1, along)
    left = Shards([torch.zeros_like(t) if p == 0 else t for p, t in zip(pos, left.parts)], mesh)
    right = Shards([torch.zeros_like(t) if p == num - 1 else t
                    for p, t in zip(pos, right.parts)], mesh)
    return left, right


def _restrict_cc_shard(v: Shards, d: int, ax: int = 0) -> Shards:
    """Cell-centred restriction along the sharded grid axis ``ax``:
    ``rc[J] = (3 v[2J] + 3 v[2J+1] + v[2J-1] + v[2J+2]) / 8`` on the local
    block, the two boundary terms from one 1-element ``ppermute`` pair."""
    left, right = _cc_halo(v, d, ax)
    dim = ax - d

    def local(t, l_, r_):
        t = torch.movedim(t, dim, -1)
        a, b = t[..., 0::2], t[..., 1::2]
        lft = torch.cat([torch.movedim(l_, dim, -1), b[..., :-1]], dim=-1)  # v[2J-1]
        rgt = torch.cat([a[..., 1:], torch.movedim(r_, dim, -1)], dim=-1)  # v[2J+2]
        return torch.movedim((3.0 * (a + b) + lft + rgt) / 8.0, -1, dim)

    return Shards.map(local, v, left, right)


def _prolong_cc_shard(e: Shards, d: int, ax: int = 0) -> Shards:
    """Cell-centred prolongation along the sharded grid axis ``ax`` (the
    transpose of ``_restrict_cc_shard`` up to the 1/2 scaling)."""
    left, right = _cc_halo(e, d, ax)
    dim = ax - d

    def local(t, l_, r_):
        t = torch.movedim(t, dim, -1)
        lf = torch.cat([torch.movedim(l_, dim, -1), t[..., :-1]], dim=-1)  # ec[J-1]
        rt = torch.cat([t[..., 1:], torch.movedim(r_, dim, -1)], dim=-1)  # ec[J+1]
        even = (3.0 * t + lf) / 4.0
        odd = (3.0 * t + rt) / 4.0
        out = torch.stack([even, odd], dim=-1).reshape(t.shape[:-1] + (2 * t.shape[-1],))
        return torch.movedim(out, -1, dim)

    return Shards.map(local, e, left, right)


def _hybrid_shard(v: Shards, global_grid: GridShape, cc_shard, fns) -> Shards:
    """A hybrid transfer on the blocks of ``global_grid``, axis by axis in
    order (the unsharded operator's order): a sharded cell-centred axis by
    ``cc_shard`` (its 1-element ``ppermute`` pair), every other axis by its
    local per-axis function ``fns[ax]`` (a sharded fw axis is odd, hence on
    one shard)."""
    d = len(global_grid)
    kinds = transfer.hybrid_kinds(tuple(global_grid))
    nb = v.mesh.ndim
    for ax in range(d):
        if ax < nb and kinds[ax] == "cc":
            v = cc_shard(v, d, ax)
        else:
            v = Shards.map(lambda t, ax=ax: transfer._along(fns[ax], t, ax - d), v)
    return v.contiguous()


def restrict_hybrid_shard(v: Shards, global_grid: GridShape) -> Shards:
    """Hybrid fw/cc restriction on the blocks of ``global_grid`` (axis-0
    row blocks over a 1-D mesh, 2-D blocks over a 2-D one): only the
    sharded axes cross shards (a sharded axis is even, hence
    cell-centred); the other axes run the local per-axis operators."""
    kinds = transfer.hybrid_kinds(tuple(global_grid))
    return _hybrid_shard(v, global_grid, _restrict_cc_shard,
                         [transfer._RESTRICT[k] for k in kinds])


def prolong_hybrid_shard(e: Shards, global_grid: GridShape) -> Shards:
    """Hybrid fw/cc prolongation onto the blocks of ``global_grid``."""
    kinds = transfer.hybrid_kinds(tuple(global_grid))
    return _hybrid_shard(e, global_grid, _prolong_cc_shard,
                         [lambda t, k=k, n=n: transfer._PROLONG[k](t, n)
                          for k, n in zip(kinds, global_grid)])


# ---------------------------------------------------------------------------
# the split of a hierarchy
# ---------------------------------------------------------------------------


def _halos(lvl, nb: int) -> Tuple[int, ...]:
    """The stencil's reach along each of the ``nb`` sharded grid axes."""
    return tuple(max((abs(s[a]) for s in lvl.A.shifts), default=0) for a in range(nb))


def _shardable(lvl, dims) -> bool:
    """A level runs sharded iff each sharded axis (``dims``: the shards
    along grid axes 0, 1, ...; an int for axis 0 alone) splits evenly with
    an even local extent (aggregates and cc pairs must not straddle
    shards), its stencil halo fits one neighbour hop, and its transfers are
    aggregation or hybrid (vertex-centred full weighting needs odd axes,
    which never divide an even mesh), or semicoarsening that leaves every
    split axis alone (its transfer is then the identity there, fully
    shard-local, and the local extent need not be even).  Semi levels that
    coarsen a split axis fall to the replicated tail."""
    dims = (dims,) if isinstance(dims, int) else tuple(dims)
    g = lvl.grid
    if any(g[a] % num for a, num in enumerate(dims)):
        return False
    local = [g[a] // num for a, num in enumerate(dims)]
    if any(h > n for h, n in zip(_halos(lvl, len(dims)), local)):
        return False
    split = [a for a, num in enumerate(dims) if num > 1]
    if lvl.transfer.startswith("semi"):
        mask = _semi_mask(lvl.transfer)
        return not any(mask[a] for a in split)
    if split and lvl.transfer not in ("agg", "hyb"):
        return False
    return all(local[a] % 2 == 0 for a in split)


def _const_legs(cst: ConstStencilMatrix, r0, r1, dtype, device) -> torch.Tensor:
    """The block [r0, r1) of ``const_to_stencil(cst)``'s legs (ints: rows
    of axis 0; tuples: ranges of the leading axes), built on ``device``:
    each coefficient where the neighbour lies in the grid, 0 where it
    leaves it (the same values, computed in fp64 and cast)."""
    g = tuple(cst.grid)
    d = len(g)
    lo = (r0,) if isinstance(r0, int) else tuple(r0)
    hi = (r1,) if isinstance(r1, int) else tuple(r1)
    lo = lo + (0,) * (d - len(lo))
    hi = hi + tuple(g[len(hi):])
    shape = tuple(b - a for a, b in zip(lo, hi))
    legs = torch.empty((cst.nlegs,) + shape, dtype=torch.float64, device=device)
    for k, (sh, c) in enumerate(zip(cst.shifts, cst.coeffs)):
        valid = torch.ones(shape, dtype=torch.bool, device=device)
        for ax, s in enumerate(sh):
            idx = torch.arange(lo[ax], hi[ax], device=device) + s
            view = [1] * d
            view[ax] = -1
            valid &= ((idx >= 0) & (idx < g[ax])).reshape(view)
        legs[k] = torch.where(valid, torch.tensor(float(c), dtype=torch.float64, device=device),
                              torch.zeros((), dtype=torch.float64, device=device))
    return legs.to(dtype).contiguous()


@dataclasses.dataclass
class ShardLevel:
    """One sharded level: ``op`` its V-cycle product (``HaloStencil``), the
    shard blocks of ``inv_diag`` (a replicated scalar on a constant level),
    ``weight`` and ``mask`` (``None`` where the level has none), and the
    level's global grid, Chebyshev bounds, transfer kind and SA flag."""

    op: HaloStencil
    inv_diag: Shards
    weight: Optional[Shards]
    mask: Optional[Shards]
    grid: GridShape
    bounds: Tuple[float, float]
    kind: str
    sa_smooth: bool


@dataclasses.dataclass
class ShardHierarchy:
    """A hierarchy built on the mesh, already split and placed: ``levels``
    the sharded levels (``ShardLevel``, each over the builder's slabs of
    legs in its ``HaloStencil``), ``tail`` the replicated levels and the
    coarse inverse on the mesh's first device (an ``MgHierarchy``, which
    also holds the cycle's smoother settings), ``grid`` the fine grid,
    ``mesh`` the mesh, ``real0`` the fine grid's real extent of axis 0 (the
    rows from it on are identity padding).  What ``precond.distributed``'s
    builders return and ``make_shard_vcycle(hierarchy=)`` takes as it is:
    nothing is gathered or copied.  ``setup_s`` splits the builder's
    host-clock seconds by phase, ``host_reads`` counts its device-to-host
    reads, ``setup_products`` lists each level's (grid, shards, stencil
    products) of the setup and ``near_null`` each coarsened level's (grid,
    constant's Rayleigh quotient, checkerboard's, transfer) as read."""

    levels: Tuple[ShardLevel, ...]
    tail: MgHierarchy
    grid: GridShape
    mesh: Mesh
    real0: int
    setup_s: dict = dataclasses.field(default_factory=dict)
    host_reads: int = 0
    setup_products: Tuple[Tuple[GridShape, int, int], ...] = ()
    near_null: Tuple[Tuple[GridShape, float, float, str], ...] = ()

    coarse_inv = property(lambda self: self.tail.coarse_inv)
    smoother = property(lambda self: self.tail.smoother)
    pre = property(lambda self: self.tail.pre)
    post = property(lambda self: self.tail.post)
    omega = property(lambda self: self.tail.omega)


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """What a sharded V-cycle runs: ``n_sharded`` levels on blocks (each
    with its global grid, local extent, halo (a pair over a 2-D mesh) and
    kind), the tail's level
    grids (replicated, on the first shard's device, then the dense
    inverse of ``coarse``), the sharded-level products of one cycle (each
    one launch a shard a column), and the bytes a cycle moves between
    shards for one column: each sharded-level product's slabs and the cc
    transfers' 1-element pairs."""

    n_sharded: int
    levels: Tuple[Tuple[GridShape, GridShape, int, str], ...]
    tail: Tuple[GridShape, ...]
    coarse: int
    products_per_cycle: int
    halo_bytes_per_cycle: int
    cc_bytes_per_cycle: int


def block_range(mesh: Mesh, i: int, local: GridShape):
    """(lo, hi): the global index range of shard ``i``'s block along each
    sharded grid axis (axis 0 over a 1-D mesh; 0 and 1 over a 2-D one)."""
    c = mesh.coords(i)
    lo = tuple(c[a] * local[a] for a in range(mesh.ndim))
    return lo, tuple(v + local[a] for a, v in enumerate(lo))


def _shard_levels(h: MgHierarchy, n_sharded: int, mesh: Mesh, dt) -> Tuple[ShardLevel, ...]:
    """Place the first ``n_sharded`` levels of ``h`` on the mesh as
    blocks (axis-0 rows over a 1-D mesh, 2-D blocks over a 2-D one);
    constant levels expanded to legs."""
    nb = mesh.ndim
    dt = torch_dtype(dt)
    vdims, ldims = tuple(range(nb)), tuple(range(1, nb + 1))
    out = []
    for lvl in h.levels[:n_sharded]:
        g = tuple(lvl.grid)
        local = tuple(g[a] // mesh.dims[a] for a in range(nb))
        if isinstance(lvl.A, ConstStencilMatrix):
            legs = Shards([_const_legs(lvl.A, *block_range(mesh, i, local), dt, d)
                           for i, d in mesh.shards()], mesh)
        else:
            legs = shard_blocks(mesh, lvl.A.data, ldims, dt)
        invd = lvl.inv_diag
        inv = (replicate(mesh, invd, dt) if invd.ndim == 0
               else shard_blocks(mesh, invd.reshape(g), vdims, dt))
        weight = None if lvl.weight is None else shard_blocks(mesh, lvl.weight.reshape(g), vdims,
                                                              dt)
        mask = None if lvl.mask is None else shard_blocks(mesh, lvl.mask.reshape(g), vdims)
        out.append(ShardLevel(HaloStencil(legs, lvl.A.shifts, _halos(lvl, nb)), inv, weight, mask,
                              g, tuple(lvl.cheb_bounds), lvl.transfer, lvl.sa_smooth))
    return tuple(out)


def _cc_bytes(grid: GridShape, mesh: Mesh, itemsize: int) -> int:
    """Bytes one restrict and one prolong of a hybrid level move between
    shards: each sharded cell-centred axis's 1-element pair, its face the
    block as the transfer finds it (the axes before it already transferred,
    coarse on the way down and fine on the way up)."""
    kinds = transfer.hybrid_kinds(tuple(grid))
    coarse = transfer.hybrid_coarse_shape(tuple(grid))
    local = lambda g, a: g[a] // mesh.dims[a] if a < mesh.ndim else g[a]
    total = 0
    for ax in range(mesh.ndim):
        if kinds[ax] != "cc" or mesh.dims[ax] == 1:
            continue
        down = math.prod(local(coarse if b < ax else grid, b) for b in range(len(grid)) if b != ax)
        up = math.prod(local(grid if b < ax else coarse, b) for b in range(len(grid)) if b != ax)
        total += 2 * mesh.size * (down + up) * itemsize
    return total


def _plan(levels, rep_h: MgHierarchy, itemsize: int, smoother: str, pre: int, post: int) -> ShardPlan:
    """The ``ShardPlan`` of a split hierarchy (bytes of one column)."""
    # products a level runs per cycle: pre and post smoothing (Chebyshev:
    # 1 + degree; Jacobi: 1 a sweep; rbgs: 2 a sweep), the residual, and
    # the SA transfers' two
    def products(sweeps):
        if sweeps <= 0:
            return 0
        return {"chebyshev": 1 + sweeps, "rbgs": 2 * sweeps}.get(smoother, sweeps)

    halo = cc = count = 0
    for L in levels:
        n = products(pre) + products(post) + 1 + (2 if L.kind == "agg" and L.sa_smooth else 0)
        count += n
        halo += n * L.op.halo_bytes
        if L.kind == "hyb":
            cc += _cc_bytes(L.grid, L.op.mesh, itemsize)
    return ShardPlan(
        n_sharded=len(levels),
        levels=tuple((L.grid, L.op.local, L.op.halos if len(L.op.halos) > 1 else L.op.halo,
                      L.kind) for L in levels),
        tail=tuple(tuple(lvl.grid) for lvl in rep_h.levels),
        coarse=int(rep_h.coarse_inv.shape[0]), products_per_cycle=count,
        halo_bytes_per_cycle=halo, cc_bytes_per_cycle=cc)


def _prep_shard_hierarchy(A_dia, grid, mesh: Mesh, axis: str, smoother: str, pre: int, post: int,
                          dt, hierarchy: Optional[MgHierarchy], **build_kw):
    """Shared setup of the explicit-collective multigrid paths: build (or
    take) the hierarchy on the mesh's first device (``build_kw`` to
    ``build_hierarchy``: ``coarse_operator=``), split it at the deepest
    shardable level, and place the sharded levels on the mesh.

    Returns ``(h, n_sharded, levels, rep_h)``: the hierarchy, the split,
    the ``ShardLevel``s and the replicated tail (an ``MgHierarchy`` of the
    remaining levels and the coarse inverse, on the first shard's
    device).  A ``ShardHierarchy`` is that split already: it is returned
    as it is."""
    grid = tuple(grid)
    if isinstance(hierarchy, ShardHierarchy):
        if hierarchy.mesh.layout != mesh.layout or hierarchy.grid != grid:
            raise ValueError(f"the hierarchy was built for {hierarchy.grid} on "
                             f"{hierarchy.mesh}, not {grid} on {mesh}")
        if not hierarchy.levels:
            raise ValueError(f"fine grid {grid}: no level of the hierarchy shards over "
                             f"{mesh.size} devices")
        return hierarchy, len(hierarchy.levels), hierarchy.levels, hierarchy.tail
    h = hierarchy or build_hierarchy(A_dia, grid, smoother=smoother, pre=pre, post=post,
                                     dtype=dt, layout="stencil", device=mesh.local_devices[0],
                                     **build_kw)
    if not h.levels or not isinstance(h.levels[0].A, (StencilMatrix, ConstStencilMatrix)):
        raise ValueError("make_shard_mgcg needs a stencil-layout hierarchy with >= 1 level")
    n_sharded = 0
    for lvl in h.levels:
        if not _shardable(lvl, mesh.dims):
            break
        n_sharded += 1
    if n_sharded == 0:
        raise ValueError(
            f"fine grid {grid} does not shard over the mesh's {mesh.dims} devices "
            "(need even local extents and agg/hyb transfers, or "
            "semicoarsening that leaves axis 0 alone — reorder axes so the "
            "coarsened/strong axes trail); use parallel.gspmd"
        )
    levels = _shard_levels(h, n_sharded, mesh, dt)
    rep_h = MgHierarchy(list(h.levels[n_sharded:]), h.coarse_inv, h.smoother, h.pre, h.post,
                        h.omega)
    return h, n_sharded, levels, rep_h


def make_vcycle(h: MgHierarchy, levels, rep_h: MgHierarchy, d: int):
    """The sharded V-cycle ``M(r)`` over ``levels`` and the replicated tail
    ``rep_h``: ``r`` a ``Shards`` of grid blocks whose trailing ``d`` dims
    are the grid (a leading column axis rides along: each column runs the
    single-RHS cycle, the tail one column at a time)."""
    n_sharded = len(levels)

    def smooth(L: ShardLevel, b, x, sweeps, post=False):
        if sweeps <= 0:
            return x
        if h.smoother == "chebyshev":
            lo, hi = L.bounds
            return chebyshev_smooth(L.op, L.inv_diag, b, x, sweeps, hi, lo)
        if h.smoother == "rbgs":
            fn = redblack_gs_smooth_reversed if post else redblack_gs_smooth
            return fn(L.op, L.inv_diag, b, x, sweeps, L.mask)
        return jacobi_smooth(L.op, L.inv_diag, b, x, sweeps, h.omega)

    def tail(r: Shards) -> Shards:
        mesh = r.mesh
        r_g = r.gather_grid(d)
        with no_tf32():  # the dense coarse product in full fp32
            if r_g.dim() == d:
                e_g = v_cycle(rep_h, r_g)
            else:
                e_g = torch.stack([v_cycle(rep_h, c) for c in r_g.reshape((-1,) + r_g.shape[-d:])])
                e_g = e_g.reshape(r_g.shape)
        return shard_blocks(mesh, e_g, tuple(range(-d, -d + mesh.ndim)))

    def cycle(level: int, r: Shards) -> Shards:
        if level == n_sharded:
            return tail(r)
        L = levels[level]
        op = L.op
        x = torch.zeros_like(r)
        x = smooth(L, r, x, h.pre)
        res = r - op(x)
        local = tuple(r.shape[-d:])
        if L.kind == "agg" and L.sa_smooth:
            c = _SA_W / L.bounds[1]
            rc = Shards.map(lambda t: _restrict_agg(t, d), L.weight * (res - c * op(L.inv_diag * res)))
            ec = cycle(level + 1, rc)
            w = L.weight * Shards.map(lambda t: _prolong_agg(t, local), ec)
            x = x + (w - c * (L.inv_diag * op(w)))
        elif L.kind == "agg":
            # plain weighted aggregation (sa_smooth=False): the transfers of
            # the unsmoothed P the coarse Galerkin products were built from
            rc = Shards.map(lambda t: _restrict_agg(t, d), L.weight * res)
            ec = cycle(level + 1, rc)
            x = x + L.weight * Shards.map(lambda t: _prolong_agg(t, local), ec)
        elif L.kind == "hyb":
            ec = cycle(level + 1, restrict_hybrid_shard(res, L.grid))
            x = x + prolong_hybrid_shard(ec, L.grid)
        elif L.kind.startswith("semi"):
            # axis 0 unmasked (_shardable): the partial transfers are local
            smask = _semi_mask(L.kind)
            ec = cycle(level + 1, Shards.map(lambda t: _restrict_partial(t, smask), res))
            x = x + Shards.map(lambda t: _prolong_partial(t, local, smask), ec)
        else:  # full weighting: one shard only
            ec = cycle(level + 1, Shards.map(lambda t: _restrict_fw(t, d), res))
            x = x + Shards.map(lambda t: _prolong_fw(t, local), ec)
        return smooth(L, r, x, h.post, post=True)

    return lambda r: cycle(0, r)


def make_shard_vcycle(
    A_dia,
    grid,
    mesh: Mesh,
    axis: str = "x",
    smoother: Optional[str] = None,
    pre: Optional[int] = None,
    post: Optional[int] = None,
    dtype=None,
    hierarchy: Optional[MgHierarchy] = None,
    axes=None,
    **build_kw,
):
    """The sharded V-cycle as a right preconditioner: ``M(r)`` on a
    ``Shards`` of grid blocks (``(n0 / num, *rest)`` a shard over a 1-D
    mesh, ``(n0 / px, n1 / py, *rest)`` over a 2-D one; ``axes``, when
    given, must name the mesh's axes), the sharded levels on
    ``HaloStencil`` (kernel #3 a shard) and the replicated tail once on
    the mesh's first device.  What MGCG takes as
    its ``M`` and the sharded nonsymmetric loops take as theirs
    (``parallel.gspmd.make_gspmd_mg_nonsym``: Jacobi smoothing, the
    rediscretized ``coarse_operator=`` levels, hybrid cell-centred
    transfers on even grids).  ``A_dia`` is the host fp64 DIA; ``dtype``
    (default its data's) is the cycle's and the hierarchy's when it is
    built here (``build_kw`` to ``build_hierarchy``); ``smoother``, ``pre``
    and ``post`` are the hierarchy's (None: chebyshev, 2, 2 when it is
    built here).  A ``ShardHierarchy`` (``precond.distributed``'s
    builders) is taken as it is, its sharded levels and tail already
    placed, with its own smoother settings and dtype: ``A_dia`` is then
    unused, and a ``smoother``, ``pre``, ``post`` or ``dtype`` that
    differs from the hierarchy's raises.

    ``M.plan`` is the ``ShardPlan`` (the one split computation of the
    sharded paths), ``M.op`` the fine level's ``HaloStencil`` with buffers
    of its own (the outer loop's product), ``M.hierarchy`` the
    hierarchy."""
    grid = tuple(grid)
    if axes is not None:
        mesh.check_axes(axes)
    if isinstance(hierarchy, ShardHierarchy):
        given = dict(smoother=smoother, pre=pre, post=post,
                     dtype=None if dtype is None else torch_dtype(dtype))
        own = dict(smoother=hierarchy.smoother, pre=hierarchy.pre, post=hierarchy.post,
                   dtype=hierarchy.coarse_inv.dtype)
        clash = {k: v for k, v in given.items() if v is not None and v != own[k]}
        if clash:
            raise ValueError(f"{clash} differ from the given hierarchy's {own}")
        dt = None
    else:
        dt = _np_dtype(dtype if dtype is not None else np.asarray(A_dia.data).dtype)
        smoother = "chebyshev" if smoother is None else smoother
        pre, post = (2 if pre is None else pre), (2 if post is None else post)
    h, _, levels, rep_h = _prep_shard_hierarchy(A_dia, grid, mesh, axis, smoother, pre, post, dt,
                                                hierarchy, **build_kw)
    M = make_vcycle(h, levels, rep_h, len(grid))
    itemsize = torch.empty(0, dtype=levels[0].inv_diag.dtype).element_size()
    M.plan = _plan(levels, rep_h, itemsize, h.smoother, h.pre, h.post)
    M.op = levels[0].op.sibling()
    M.levels = levels
    M.hierarchy = h
    return M


def make_shard_mgcg(
    system,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy: Optional[MgHierarchy] = None,
    variant: str = "cg",
):
    """Build an explicit-collective MGCG solver over a mesh (axis-0 row
    blocks over a 1-D mesh, 2-D blocks over a 2-D one; ``axis`` is unused,
    the JAX signature's).

    Returns ``(solve, (b, x0))`` with ``solve(b, x0) -> CGResult`` (a flat
    global x on the mesh's first device; on a mesh that spans processes,
    the ``Shards`` of this process's grid blocks) and ``b``, ``x0`` the system's
    vectors placed as ``Shards`` of grid blocks; ``solve`` takes such
    ``Shards`` (or global arrays, split here).  ``system`` is a
    ``core.generators.LinearSystem`` (host fp64 DIA ``A``, ``b``, ``x0``);
    ``dtype`` (default ``A.data``'s) is the solve's, and the hierarchy's
    when it is built here (on the mesh's first device).  ``variant``
    selects the outer loop's communication structure (``sharded_cg_loop``:
    ``"cg"``, ``"cg1"`` or ``"pipelined"``).  ``solve.plan`` is the
    ``ShardPlan``; ``solve.operators`` the outer loop's ``HaloStencil``
    and each sharded level's; ``solve.shards(b, x0)`` returns x as the
    ``Shards`` of grid blocks, ungathered."""
    if variant not in ("cg", "cg1", "pipelined"):
        raise ValueError(f"variant {variant!r}: the V-cycle preconditions cg|cg1|pipelined")
    grid = tuple(grid)
    dt = _np_dtype(dtype if dtype is not None else np.asarray(system.A.data).dtype)
    M = make_shard_vcycle(system.A, grid, mesh, axis, smoother, pre, post, dt, hierarchy)
    op0 = M.op  # the outer loop's own buffers
    n = int(np.prod(grid))

    def place(v):
        if isinstance(v, Shards):
            return v
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        return shard_blocks(mesh, t.reshape(grid), (0, 1), dt)

    def solve_shards(b, x0) -> CGResult:
        return sharded_cg_loop(op0, M, place(b), place(x0), policy, n, variant=variant)

    def solve(b, x0) -> CGResult:
        res = solve_shards(b, x0)
        if mesh.comm is not None:
            return res
        return dataclasses.replace(res, x=res.x.gather_grid(len(grid)).reshape(-1))

    solve.shards = solve_shards
    solve.plan = M.plan
    solve.operators = (op0,) + tuple(L.op for L in M.levels)
    return solve, (place(system.b), place(system.x0))


def shard_mgcg_solve(
    system,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    **kw,
) -> CGResult:
    """One-call convenience: build, place, solve (``mesh``: every visible
    CUDA device by default)."""
    if mesh is None:
        mesh = make_mesh()
    solve, (b, x0) = make_shard_mgcg(system, grid, mesh, policy, **kw)
    return solve(b, x0)
