"""Distributed multigrid setup: the hierarchy built on the shards.

The port of ``conjugategradient_tpu/precond/distributed.py``.
``precond.multigrid.build_hierarchy`` computes the coarse operators on the
host (scipy triple products) from the global fine matrix, which caps it at
what one host holds.  These builders take a fine ``StencilMatrix`` whose
legs are a ``parallel.mesh.Shards`` of axis-0 blocks (``parallel.rung5``'s
assembly) and build the hierarchy on the shards' devices; the host reads
only O(levels) scalars and the coarsest level.

``build_hierarchy_probed`` builds the hierarchy that
``build_hierarchy(..., layout="stencil", sa_smooth_levels=0)`` builds
(plain weighted aggregation or hybrid fw/cell-centred transfers, the same
choices), its coarse operators by coset probing: the Galerkin operator
``C = R A P`` of a fine stencil of extent <= 1 per axis has extent <= 1
(aggregation, full weighting) or 2 (cell-centred axes) per axis, so two
coarse columns with the same residue mod ``p = 2 * extent + 1`` per axis
never meet in a row, and ``C`` applied to the indicator of each residue
class gives every leg:

    legs[s][j] = (C e_{(j+s) mod p})[j].

Each probe is ``P``, the sharded product and ``R`` on the shards: the
stencil product is ``parallel.halo.HaloStencil`` (kernel #3 on each
shard's extended slab, its twin on a CPU tensor), the aggregation
transfers are ``parallel.shard_mgcg``'s shard-local ``_restrict_agg`` /
``_prolong_agg``, the hybrid ones ``restrict_hybrid_shard`` /
``prolong_hybrid_shard``, and dots and norms ``psum`` in shard order.  The
probes run one after another, and each probe's result is scattered
straight into the coarse legs it determines (every leg entry comes from
exactly one probe), so the peak is one fine-sized apply.  Everything that
depends on a global index (the coset masks, the checkerboard candidate,
the power iteration's start vector, the leg scatter) offsets a shard's
indices by its block's origin: its first global row over a 1-D mesh, its
first row and column over a 2-D one (``axes=("x", "y")``: 2-D blocks,
the JAX package's block partition).  Structurally zero legs are pruned
by the exact ``> 0`` test on their global maxima.

A level is built sharded when ``parallel.shard_mgcg``'s V-cycle can carry
it (each sharded axis divides the mesh into even local extents its halo
fits in, ``_shardable``): the JAX package's ``specs_for_grid`` rule, narrowed to
what the explicit-collective cycle runs.  From the first level that is not,
the levels are built replicated on the mesh's first device, as GSPMD
replicates a level that does not divide (its products kernel #3 on the
whole grid).  The builders return a ``parallel.shard_mgcg.ShardHierarchy``:
the sharded levels placed (``ShardLevel``, over the builder's ``Shards``),
the replicated tail an ``MgHierarchy`` on the first device, so
``make_shard_vcycle`` and ``parallel.rung5``'s factories take it with no
gather and no second copy of a level's legs.  The coarsest level (<=
``max_coarse`` rows) is read to the host and inverted densely.

``build_hierarchy_redisc`` assembles every level slab by slab from a
closed-form generator (``core.generators.convection_diffusion_level_slab``)
into the same form: no Galerkin product, no probing.
"""

from __future__ import annotations

import time
from itertools import product
from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import StencilMatrix, torch_dtype
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_stencil_cuda
from conjugategradient_tpu_torch.parallel.halo import HaloStencil, SlabStencil, zero_halo_slab
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, pmax, psum, specs_for_grid
from conjugategradient_tpu_torch.parallel.rung5 import unit_shifts
from conjugategradient_tpu_torch.parallel.shard_mgcg import (
    ShardHierarchy,
    ShardLevel,
    _prolong_agg,
    _restrict_agg,
    prolong_hybrid_shard,
    restrict_hybrid_shard,
)
from conjugategradient_tpu_torch.precond import transfer
from conjugategradient_tpu_torch.precond.multigrid import MgHierarchy, MgLevel

GridShape = Tuple[int, ...]


def _box_shifts(extents: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """The full per-axis shift box prod_ax {-e_ax..e_ax}, sorted (matches
    ``unit_shifts``'s ordering convention for the subset it covers)."""
    return tuple(sorted(product(*[range(-e, e + 1) for e in extents])))


# ---------------------------------------------------------------------------
# global indices on a shard's block: offset by the block's origin
# ---------------------------------------------------------------------------


def _iota(local: GridShape, ax: int, origin, device) -> torch.Tensor:
    """The global index along axis ``ax`` of a shard's block ``local``
    whose origin is ``origin`` (an int: the first row of axis 0; a tuple:
    the first index of each leading axis), broadcastable to it."""
    org = (origin,) if isinstance(origin, int) else tuple(origin)
    i = torch.arange(local[ax], device=device) + (org[ax] if ax < len(org) else 0)
    shape = [1] * len(local)
    shape[ax] = local[ax]
    return i.reshape(shape)


def _iota_mod(local: GridShape, periods: Tuple[int, ...], origin=0, device=None):
    """Per axis, the global index mod its period on the block ``local`` at
    ``origin``."""
    return [_iota(local, ax, origin, device) % periods[ax] for ax in range(len(local))]


def _coset_mask(iotas, c: Tuple[int, ...]) -> torch.Tensor:
    m = None
    for ax, r in enumerate(c):
        e = iotas[ax] == r
        m = e if m is None else (m & e)
    return m


def _checkerboard(local: GridShape, dtype, origin=0, device=None) -> torch.Tensor:
    """The alternating candidate on the block: +1 where the global indices
    sum to an even number, -1 elsewhere."""
    par = None
    for ax in range(len(local)):
        i = _iota(local, ax, origin, device)
        par = i if par is None else par + i
    par = par.expand(tuple(local))
    one = torch.ones((), dtype=dtype, device=device)
    return torch.where(par % 2 == 0, one, -one)


def _origins(mesh: Mesh, local: GridShape):
    """Each owned shard's block origin on the leading ``mesh.ndim`` axes."""
    return [tuple(c * n for c, n in zip(mesh.coords(i), local)) for i in mesh.owned]


def _halos(shifts, nb: int) -> Tuple[int, ...]:
    return tuple(max(abs(s[a]) for s in shifts) for a in range(nb))


class _Level:
    """A level under construction: its legs (a ``Shards`` over the mesh
    when sharded, over the first device alone when replicated), shifts,
    global grid and the product over them.  A sharded level comes with
    ``slabs``, the zero-haloed slabs its legs are the middle of
    (``zero_halo_slab``, extended on every sharded axis), and its product
    is ``HaloStencil.from_slabs`` over them; a replicated one runs kernel
    #3 on the whole grid."""

    def __init__(self, legs: Shards, shifts, grid: GridShape, slabs: Optional[Shards] = None):
        self.legs, self.shifts, self.grid = legs, tuple(shifts), tuple(grid)
        self.sharded = slabs is not None
        self.mesh = legs.mesh
        self.local = tuple(legs.shape[1:])
        self.origins = _origins(self.mesh, self.local)
        d = len(self.grid)
        self.center = self.shifts.index((0,) * d)
        if self.sharded:
            halos = _halos(self.shifts, self.mesh.ndim)
            self.op = HaloStencil.from_slabs(slabs, self.shifts, halos)
        else:
            A = StencilMatrix(legs.parts[0], self.shifts, self.grid)
            self.op = lambda x: Shards.map(lambda t: spmv_stencil_cuda(A, t), x)

    def fill(self, fn) -> Shards:
        """``fn(origin, device)`` on each shard: a ``Shards`` of its blocks."""
        return Shards([fn(o, dv) for o, dv in zip(self.origins, self.mesh.local_devices)],
                      self.mesh)


def _pdot(u: Shards, v: Shards) -> torch.Tensor:
    """Global u.v on the first shard's device: local dots, one ``psum``."""
    return psum(Shards.map(lambda a, b: torch.dot(a.reshape(-1), b.reshape(-1)), u, v)).parts[0]


def _agg_weights_dev(z: Shards, fine: GridShape):
    """Device twin of ``multigrid._agg_weights`` on the shards' blocks
    (``fine`` the local extents): per-aggregate-normalised candidate ->
    (W, z_coarse).  ``_restrict_agg`` averages pairs per axis (odd tails
    zero-padded), so the aggregate SUM is ``2^d *`` it; a sharded block's
    even axis 0 holds whole aggregates."""
    d = len(fine)
    zz = z * z
    agg = Shards.map(lambda t: _restrict_agg(t, d), zz) * (2.0 ** d)
    nrm = Shards.map(torch.sqrt, agg)
    expand = Shards.map(lambda t: _prolong_agg(t, fine), nrm)

    def weights(z_, e_):
        ok = e_ > 0
        return torch.where(ok, z_ / torch.where(ok, e_, torch.ones_like(e_)),
                           torch.ones_like(e_))

    return Shards.map(weights, z, expand), nrm


def _near_null_dev(L: _Level):
    """Rayleigh quotients (z^T A z / z^T z) of the two global candidates
    (constant, checkerboard): the device twin of ``multigrid._near_null``.
    Two 0-d tensors on the first device; the caller picks on the host."""
    dt = L.legs.dtype
    ones = L.fill(lambda o, dv: torch.ones(L.local, dtype=dt, device=dv))
    alt = L.fill(lambda o, dv: _checkerboard(L.local, dt, o, dv))

    def q(z):
        return _pdot(z, L.op(z)) / _pdot(z, z)

    return q(ones), q(alt)


def _lam_max_dev(L: _Level, inv_diag: Shards, iters: int = 30) -> torch.Tensor:
    """Power iteration for lam_max(D^{-1} A) on the shards' blocks.

    Deterministic rough start, ``sin(0.7 * flat index) + 0.1`` over the
    level's global (padded) grid; matches ``eigen.scaled_spectrum_bounds``'s
    estimate up to iteration noise."""
    g = L.grid
    dt = L.legs.dtype

    def start(org, dv):
        idx = None
        for ax in range(len(g)):
            i = _iota(L.local, ax, org, dv)
            idx = i if idx is None else idx * g[ax] + i
        return torch.sin(0.7 * idx.expand(L.local).to(dt)) + 0.1

    v = L.fill(start)
    v = v / _pdot(v, v).sqrt()
    lam = torch.zeros((), dtype=dt, device=L.mesh.local_devices[0])
    for _ in range(iters):
        w = inv_diag * L.op(v)
        lam = _pdot(w, v)
        nw = _pdot(w, w).sqrt()
        v = w / torch.where(nw == 0, torch.ones_like(nw), nw)
    return lam


def _probe_geometry(fine: GridShape, kind: str):
    """(coarse_shape, periods, extents) for coset probing.

    The coarse operator's per-axis coupling EXTENT sets the probing period:
    two coarse columns with the same residue mod p are p apart, so probing
    is exact iff p >= 2*extent + 1.  Plain aggregation and full weighting
    keep extent 1 (period 3); cell-centered interpolation has extent 2
    (period 5): mixed hybrid axes probe with mixed periods."""
    if kind == "hyb":
        kinds = transfer.hybrid_kinds(fine)
        gc = transfer.hybrid_coarse_shape(fine)
        extents = tuple(2 if k == "cc" else 1 for k in kinds)
    else:
        gc = transfer.agg_coarse_shape(fine)
        extents = tuple(1 for _ in fine)
    periods = tuple(2 * e + 1 for e in extents)
    return gc, periods, extents


def _probe_coarse(L: _Level, W: Optional[Shards], kind: str = "agg") -> Shards:
    """The coarse legs of C = R A P by per-axis coset probing, over the
    full shift box of the coarse extents: a ``Shards`` of the coarse
    blocks ``(len(box), *local coarse grid)``.

    ``kind``: "agg" = plain weighted aggregation (C = R_w A P_w with the
    aggregate weights ``W``); "hyb" = per-axis fw/cell-centred
    interpolation (``W`` unused).  The probes run in turn; probe c's
    result is scattered into each leg s at the coarse points j with
    ``(j + s) mod p == c`` (global j), a strided sub-lattice of the block."""
    fine = L.grid
    d = len(fine)
    gc, periods, extents = _probe_geometry(fine, kind)
    box = _box_shifts(extents)
    mesh = L.mesh
    local_c = tuple(n // mesh.dims[a] if a < mesh.ndim else n for a, n in enumerate(gc))
    corigins = _origins(mesh, local_c)
    dt = L.legs.dtype
    iotas = [_iota_mod(local_c, periods, o, dv) for o, dv in zip(corigins, mesh.local_devices)]
    out = Shards([torch.zeros((len(box),) + local_c, dtype=dt, device=dv)
                  for dv in mesh.local_devices], mesh)
    for c in product(*[range(p) for p in periods]):
        e0 = Shards([_coset_mask(io, c).expand(local_c).to(dt) for io in iotas], L.mesh)
        if kind == "hyb":
            y = restrict_hybrid_shard(L.op(prolong_hybrid_shard(e0, fine)), fine)
        else:
            v = W * Shards.map(lambda t: _prolong_agg(t, L.local), e0)
            y = Shards.map(lambda t: _restrict_agg(t, d), W * L.op(v))
        for o, y_, org in zip(out.parts, y.parts, corigins):
            offs = org + (0,) * (d - len(org))
            for k, s in enumerate(box):
                sl = tuple(slice((c[ax] - s[ax] - offs[ax]) % periods[ax], None, periods[ax])
                           for ax in range(d))
                o[(k,) + sl] = y_[sl]
    return out


def _specs_for(g: GridShape, mesh: Mesh, axes: Tuple[str, ...]):
    """Shared divisibility rule: ``parallel.mesh.specs_for_grid``."""
    return specs_for_grid(g, mesh, axes)


def _carried(g: GridShape, halos, mesh: Mesh, axes: Tuple[str, ...]) -> bool:
    """Whether a level of grid ``g`` (agg or hyb transfers, ``halos`` its
    reach along each sharded axis) is built sharded: each axis the mesh
    splits shards (``_specs_for``) and the sharded V-cycle carries it
    (``shard_mgcg._shardable``: an even local extent, the halo within it;
    any split on one shard)."""
    names = _specs_for(g, mesh, axes).names
    for a, num in enumerate(mesh.dims):
        n = g[a] // num
        if (num > 1 and (not names[a] or n % 2)) or halos[a] > n:
            return False
    return True


def _first(mesh: Mesh) -> Mesh:
    """This process's first device alone: where the replicated levels live
    (every process holds them, as JAX replicates them on every device)."""
    return Mesh(mesh.local_devices[:1], mesh.axes[0])


def _as_tensor(legs) -> torch.Tensor:
    if isinstance(legs, Shards):
        return legs.gather_grid(legs.parts[0].dim() - 1)
    return legs if torch.is_tensor(legs) else torch.from_numpy(np.asarray(legs))


def _place(legs, shifts, g: GridShape, mesh: Mesh, axes, dt) -> _Level:
    """A level's legs onto the mesh: carried sharded, each shard's block
    copied into a zero-haloed slab on its device (``zero_halo_slab``; a
    global array is split first), so its ``HaloStencil`` copies nothing
    more; otherwise the global legs on the first device."""
    halos = _halos(shifts, mesh.ndim)
    if not _carried(g, halos, mesh, axes):
        t = _as_tensor(legs).to(device=mesh.local_devices[0], dtype=dt).contiguous()
        return _Level(Shards([t], _first(mesh)), shifts, g)
    local = tuple(n // mesh.dims[a] if a < mesh.ndim else n for a, n in enumerate(g))
    if isinstance(legs, Shards) and legs.mesh.layout == mesh.layout:
        blocks = legs.parts
    else:
        blocks = [_as_tensor(legs)]
        for a, num in enumerate(mesh.dims):
            blocks = [c for blk in blocks for c in torch.chunk(blk, num, dim=1 + a)]
        blocks = [blocks[i] for i in mesh.owned]
    slabs, mids = [], []
    for b, dv in zip(blocks, mesh.local_devices):
        slab, mid = zero_halo_slab(len(shifts), local, halos, dt, dv)
        mid.copy_(b)
        slabs.append(slab)
        mids.append(mid)
    return _Level(Shards(mids, mesh), shifts, g, Shards(slabs, mesh))


def _fine_level(A: StencilMatrix, g: GridShape, mesh: Mesh, axes, dt) -> _Level:
    """The fine level: a ``SlabStencil`` the sharded V-cycle carries on
    this mesh keeps the assembly's slabs (no second copy of the fine
    legs); anything else is placed (``_place``)."""
    if (isinstance(A, SlabStencil) and A.data.mesh.layout == mesh.layout
            and _carried(g, (A.halo0,), mesh, axes)):
        return _Level(A.data, A.shifts, g, A.slabs)
    return _place(A.data, A.shifts, g, mesh, axes, dt)


def _level_pack(L: _Level, power_iters: int):
    """Per-level statistics: inverse diagonal, both near-null Rayleigh
    quotients, lam_max(D^{-1}A)."""
    inv_d = Shards.map(lambda t: 1.0 / t[L.center], L.legs)
    q1, q2 = _near_null_dev(L)
    lam = _lam_max_dev(L, inv_d, power_iters)
    return inv_d, q1, q2, lam


def _level_coarsen(L: _Level, z_is_ones: bool, kind: str):
    """Per-level coarsening: (aggregate weights, coarse candidate,) probed
    coarse legs (``None`` weights and candidate on a hybrid level)."""
    if kind == "hyb":
        return None, None, _probe_coarse(L, None, kind="hyb")
    dt = L.legs.dtype
    if z_is_ones:
        z = L.fill(lambda o, dv: torch.ones(L.local, dtype=dt, device=dv))
    else:
        z = L.fill(lambda o, dv: _checkerboard(L.local, dt, o, dv))
    W, z_c = _agg_weights_dev(z, L.local)
    return W, z_c, _probe_coarse(L, W)


def _legs_to_dense(legs_h: np.ndarray, shifts, g: GridShape) -> np.ndarray:
    """(nlegs, *g) stencil legs -> dense (n, n), exact grid-neighbour logic."""
    n = int(np.prod(g))
    idx = np.indices(g).reshape(len(g), -1)
    strides = np.cumprod([1] + list(g[:0:-1]))[::-1]
    out = np.zeros((n, n), dtype=legs_h.dtype)
    rows = np.arange(n)
    for k, sh in enumerate(shifts):
        nb = idx + np.asarray(sh)[:, None]
        valid = np.all((nb >= 0) & (nb < np.asarray(g)[:, None]), axis=0)
        cols = (nb * strides[:, None]).sum(axis=0)
        v = legs_h[k].reshape(-1)
        out[rows[valid], cols[valid]] += v[valid]
    return out


class _Reads:
    """The builder's device-to-host reads, counted."""

    def __init__(self):
        self.n = 0

    def __call__(self, t: torch.Tensor) -> np.ndarray:
        self.n += 1
        return t.detach().cpu().numpy()


def _finish(levels, tail, legs_h, shifts, g, dt, mesh, smoother, pre, post, omega, grid, real0,
            setup, reads, products, near_null=()) -> ShardHierarchy:
    """The coarsest level's dense inverse (fp64 on the host, cast to the
    legs' dtype) on the first device, and the split hierarchy."""
    t0 = time.perf_counter()
    dense_c = _legs_to_dense(legs_h, shifts, g)
    coarse_inv = torch.from_numpy(np.linalg.inv(dense_c.astype(np.float64)).astype(legs_h.dtype))
    rep_h = MgHierarchy(tail, coarse_inv.to(mesh.local_devices[0], dt), smoother, pre, post,
                        omega)
    setup["coarse_inv"] = time.perf_counter() - t0
    return ShardHierarchy(tuple(levels), rep_h, tuple(grid), mesh, int(real0), setup_s=setup,
                          host_reads=reads.n, setup_products=tuple(products),
                          near_null=tuple(near_null))


def _add_level(L: _Level, inv_d: Shards, W, g, bounds, kind, levels, tail):
    """Level ``L`` into the hierarchy: a ``ShardLevel`` over its own
    ``HaloStencil`` while sharded, an ``MgLevel`` on the first device in
    the replicated tail."""
    if L.sharded:
        levels.append(ShardLevel(L.op, inv_d, W, None, tuple(g), bounds, kind, False))
    else:
        tail.append(MgLevel(StencilMatrix(L.legs.parts[0], L.shifts, tuple(g)), inv_d.parts[0],
                            tuple(g), bounds, kind, weight=None if W is None else W.parts[0],
                            sa_smooth=False))


def build_hierarchy_probed(
    A: StencilMatrix,
    mesh: Mesh,
    axes: Tuple[str, ...] = ("x",),
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    power_iters: int = 30,
    transfer_kind: str = "auto",
) -> ShardHierarchy:
    """Aggregation/hybrid hierarchy from a sharded fine stencil, built on
    the mesh's devices.

    Produces the hierarchy ``build_hierarchy(..., layout="stencil",
    sa_smooth_levels=0)`` produces (the same transfers and coarse legs to
    fp round-off, the same pruned leg sets), but no host holds a level:
    only O(levels) scalars and the coarsest level are read back.  Requires
    fine extent <= 1 per axis (the probing window).  ``axes`` names the
    mesh's axes: ``("x",)`` builds on axis-0 row blocks of a 1-D mesh,
    ``("x", "y")`` on 2-D blocks of a 2-D mesh.  ``A.data`` is a
    ``Shards`` of blocks over ``mesh`` (``parallel.rung5``'s axis-0
    slabs), or a global array, split here; a ``SlabStencil``'s slabs become the fine
    level's as they are, and its ``real0`` the hierarchy's.  Returns a
    ``ShardHierarchy``: the levels the sharded V-cycle carries stay on the
    shards, the rest (coarse levels that stop dividing the mesh) on its
    first device; ``near_null`` holds each coarsened level's two Rayleigh
    quotients as read."""
    if not isinstance(A, StencilMatrix):
        raise TypeError("build_hierarchy_probed needs a StencilMatrix fine operator")
    if any(h > 1 for h in A.halo):
        raise ValueError(f"fine stencil extent {A.halo} > 1; probing window is 3^d")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unsupported smoother {smoother!r} (rbgs needs host masks)")
    if transfer_kind not in ("auto", "hyb", "agg"):
        raise ValueError(f"unknown transfer_kind {transfer_kind!r} (probed setup)")
    axes = mesh.check_axes(axes)

    def _pick(gg, geom_ok=True):
        """``geom_ok``: the constant is the near-null candidate, required
        for the geometric hyb transfers (cf. multigrid._const_near_null);
        aggregation adapts its weights to either candidate."""
        if transfer_kind == "agg":
            return "agg" if transfer.can_aggregate(gg) else None
        if transfer_kind == "hyb":
            return "hyb" if transfer.can_hybrid(gg) else None
        if geom_ok and transfer.can_hybrid(gg) and all(
            n >= 5 for n in transfer.hybrid_coarse_shape(gg)
        ):
            return "hyb"  # ~2x fewer MGCG its than plain aggregation
        if transfer.can_aggregate(gg):
            return "agg"
        return None

    setup = dict.fromkeys(("pack", "coarsen", "prune", "coarse_inv"), 0.0)
    reads = _Reads()
    g = tuple(A.grid)
    data = A.data
    dt = data.dtype if torch.is_tensor(data) or isinstance(data, Shards) else \
        torch_dtype(np.asarray(data).dtype)
    L = _fine_level(A, g, mesh, axes, dt)
    real0 = A.real0 if isinstance(A, SlabStencil) else g[0]
    levels, tail, products, near_null = [], [], [], []
    while (
        int(np.prod(g)) > max_coarse
        and _pick(g) is not None
        and len(levels) + len(tail) < max_levels - 1
    ):
        t0 = time.perf_counter()
        inv_diag, q_ones, q_alt, lam = _level_pack(L, power_iters)
        lam_h, q1_h, q2_h = (float(v) for v in reads(torch.stack([lam, q_ones, q_alt])))
        lam_f = lam_h * 1.1
        bounds = (0.25 * lam_f, lam_f)
        z_is_ones = q1_h <= q2_h
        kind = _pick(g, geom_ok=z_is_ones)
        t1 = time.perf_counter()
        setup["pack"] += t1 - t0
        if kind is None:
            break
        near_null.append((g, q1_h, q2_h, kind))
        W, _z_c, coarse_legs = _level_coarsen(L, z_is_ones, kind)
        gc, periods, extents = _probe_geometry(g, kind)
        products.append((g, L.mesh.size, int(np.prod(periods)) + power_iters + 2))
        t2 = time.perf_counter()
        setup["coarsen"] += t2 - t1
        _add_level(L, inv_diag, W if kind == "agg" else None, g, bounds, kind, levels, tail)

        # prune structurally-zero legs (host decision on the global maxima)
        box = _box_shifts(extents)
        mags = reads(pmax(Shards.map(lambda t: t.abs().flatten(1).amax(dim=1), coarse_legs))
                     .parts[0])
        keep = [k for k in range(len(box)) if mags[k] > 0]
        new_shifts = tuple(box[k] for k in keep)
        kept = Shards.map(lambda t: t[torch.tensor(keep, device=t.device)], coarse_legs)
        del coarse_legs
        if L.sharded:
            L = _place(kept, new_shifts, gc, mesh, axes, dt)
        else:
            L = _Level(kept, new_shifts, gc)
        del kept
        g = gc
        setup["prune"] += time.perf_counter() - t2

    # coarsest: tiny; read it, invert densely.  Assembled dense straight
    # from the legs: on very small grids distinct shifts can alias one
    # flat DIA offset, so no DIA round trip
    legs_h = reads(_as_tensor(L.legs))
    return _finish(levels, tail, legs_h, L.shifts, g, dt, mesh, smoother, pre, post, omega,
                   A.grid, real0, setup, reads, products, near_null)


def build_hierarchy_redisc(
    grid: GridShape,
    mesh: Mesh,
    slab_fn,
    axes: Tuple[str, ...] = ("x",),
    smoother: str = "jacobi",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    power_iters: int = 30,
    dtype=np.float32,
) -> ShardHierarchy:
    """Rediscretized sharded hierarchy: every level assembled directly from
    a closed-form generator, slab by slab, onto the shards: no Galerkin
    product, no probing, no level held whole by the host.

    The rung-5 setup for operators whose Galerkin coarsening is unstable
    (convection-dominated transport, see
    ``generators.convection_diffusion_coarse_operator``): the probed
    builder would reproduce the divergent Galerkin coarse operators.
    ``slab_fn(level, grid_l, lo0, hi0) -> (nlegs, hi0-lo0, *grid_l[1:])``
    gives host legs for axis-0 planes [lo0, hi0) of level ``level`` (over
    a 2-D mesh each block takes its columns of its planes) (e.g.
    ``generators.convection_diffusion_level_slab(eps)``, which carries the
    calibrated per-level scaling).  Transfers are the geometric hybrid
    fw/cc family; even (2^k) grids halve cleanly and divide the mesh.  Leg
    order is sorted unit shifts (``parallel.rung5.unit_shifts``).  Each
    level's bounds come from the same device power iteration as the probed
    build's.  Returns a ``ShardHierarchy`` as ``build_hierarchy_probed``."""
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unsupported smoother {smoother!r}")
    axes = mesh.check_axes(axes)
    g = tuple(int(n) for n in grid)
    d = len(g)
    shifts = unit_shifts(d)
    dt = torch_dtype(dtype)
    setup = dict.fromkeys(("assemble", "pack", "coarse_inv"), 0.0)
    reads = _Reads()

    def assemble(level, gg, sharded_so_far) -> _Level:
        sharded = sharded_so_far and _carried(gg, (1,) * mesh.ndim, mesh, axes)
        if not sharded:
            t = torch.from_numpy(np.ascontiguousarray(slab_fn(level, gg, 0, gg[0])))
            return _Level(Shards([t.to(mesh.local_devices[0], dt)], _first(mesh)), shifts, gg)
        local = tuple(n // mesh.dims[a] if a < mesh.ndim else n for a, n in enumerate(gg))
        slabs, mids = [], []
        for org, dv in zip(_origins(mesh, local), mesh.local_devices):
            slab, mid = zero_halo_slab(len(shifts), local, (1,) * mesh.ndim, dt, dv)
            legs = np.asarray(slab_fn(level, gg, org[0], org[0] + local[0]))
            if mesh.ndim == 2:  # the generator gives whole planes: this block's columns
                legs = legs[:, :, org[1]:org[1] + local[1]]
            mid.copy_(torch.from_numpy(np.ascontiguousarray(legs)))
            slabs.append(slab)
            mids.append(mid)
        return _Level(Shards(mids, mesh), shifts, gg, Shards(slabs, mesh))

    levels, tail, products = [], [], []
    lvl_idx = 0
    sharded = True
    while (
        int(np.prod(g)) > max_coarse
        and transfer.can_hybrid(g)
        # >= 5 matches the host builder's hyb gate (cell-centred Galerkin
        # stencils have extent 2; tinier axes alias shifts)
        and all(n >= 5 for n in transfer.hybrid_coarse_shape(g))
        and len(levels) + len(tail) < max_levels - 1
    ):
        t0 = time.perf_counter()
        L = assemble(lvl_idx, g, sharded)
        sharded = L.sharded
        t1 = time.perf_counter()
        setup["assemble"] += t1 - t0
        inv_diag, _q1, _q2, lam = _level_pack(L, power_iters)
        lam_f = float(reads(lam)) * 1.1
        products.append((g, L.mesh.size, power_iters + 2))
        _add_level(L, inv_diag, None, g, (0.25 * lam_f, lam_f), "hyb", levels, tail)
        setup["pack"] += time.perf_counter() - t1
        g = transfer.hybrid_coarse_shape(g)
        lvl_idx += 1

    # coarsest: tiny; assemble on the host, invert densely
    legs_h = np.asarray(slab_fn(lvl_idx, g, 0, g[0]))
    return _finish(levels, tail, legs_h, shifts, g, dt, mesh, smoother, pre, post, omega, grid,
                   grid[0], setup, reads, products)
