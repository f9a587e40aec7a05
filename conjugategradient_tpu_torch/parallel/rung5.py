"""Rung 5: grid-stencil systems assembled slab by slab onto the shards, and
their sharded solvers.

The port of ``conjugategradient_tpu/parallel/rung5.py``.  BASELINE.md's
ladder rung 5 is a Poisson MGCG of 100M+ rows whose system no host holds
whole.  The JAX package generates each device's axis-0 slab with
``jax.make_array_from_callback``; here each shard's slab is generated on
the host by the closed-form generator, copied to that shard's device and
freed before the next one is made, so the host holds one slab at a time.
The legs land inside zeroed slabs one halo row wider on each side
(``parallel.halo.zero_halo_slab``); the system's matrix is a
``parallel.halo.SlabStencil``, which hands those slabs to the sharded
product (``HaloStencil.from_slabs``, kernel #3 on each shard's extended
slab) as they are: the fine legs exist once on the mesh.

Grids are identity-padded along axis 0 to a multiple of the mesh size (a
plane of decoupled ``A[i,i] = 1`` rows whose right-hand side and start are
zero), because the row blocks must be equal and the canonical 2^k - 1
multigrid sizes are odd.  The padded plane solves to exactly zero: its
residual starts at zero under plain CG, and the multigrid solvers set the
V-cycle's output to zero there (``SlabStencil.real0``, carried into the
hierarchy), where the cycle's transfers would carry a correction in.

The solver factories return ``solve(b, x0) -> CGResult`` (``make_rung5_cg``:
``solve(A, b, x0)``) over ``Shards`` of axis-0 grid blocks; the result's
``x`` stays a ``Shards`` (``x.gather()`` is the global grid).  The
hierarchies come from ``precond.distributed``: ``build_hierarchy_probed``
(Galerkin coarse operators probed on the shards) for MGCG,
``build_hierarchy_redisc`` (every level generated slab by slab) for the
convection path.  Left out: the JAX factories' ``jax.jit``, which eager
PyTorch does not need.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import torch_dtype
from conjugategradient_tpu_torch.parallel.halo import SlabStencil, zero_halo_slab
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards
from conjugategradient_tpu_torch.parallel.shard_mgcg import make_shard_vcycle
from conjugategradient_tpu_torch.parallel.shard_nonsym import run_sharded_loop
from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_loop

GridShape = Tuple[int, ...]


def unit_shifts(d: int) -> Tuple[Tuple[int, ...], ...]:
    """Center + one ± leg per axis, sorted by flat offset (matches
    ``dia_to_stencil``'s ordering for the Poisson matrices)."""
    shifts = [tuple(0 for _ in range(d))]
    for ax in range(d):
        for s in (-1, 1):
            t = [0] * d
            t[ax] = s
            shifts.append(tuple(t))
    return tuple(sorted(shifts))


def poisson_stencil_slab(
    grid: GridShape, lo: int, hi: int, dtype=np.float32
) -> np.ndarray:
    """Stencil legs ``(nlegs, hi-lo, *grid[1:])`` for the axis-0 slab
    [lo, hi) of the identity-padded Poisson grid (Dirichlet, unit spacing;
    the closed forms of ``core.generators.poisson*_matrix``, evaluated only
    on the requested slab)."""
    d = len(grid)
    g0 = grid[0]
    shifts = unit_shifts(d)
    coords = [np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * (d - 1))]
    for ax in range(1, d):
        shp = [1] * d
        shp[ax] = grid[ax]
        coords.append(np.arange(grid[ax], dtype=np.int64).reshape(shp))
    real = coords[0] < g0
    slab_shape = (hi - lo,) + tuple(grid[1:])
    legs = np.zeros((len(shifts),) + slab_shape, dtype=dtype)
    for k, s in enumerate(shifts):
        if all(v == 0 for v in s):
            legs[k] = np.where(real, 2.0 * d, 1.0)
            continue
        ax = next(a for a, v in enumerate(s) if v)
        size = g0 if ax == 0 else grid[ax]
        nb = coords[ax] + s[ax]
        ok = real & (nb >= 0) & (nb < size)
        legs[k] = np.where(ok, -1.0, 0.0)
    return legs


def poisson_rhs_slab(
    grid: GridShape, lo: int, hi: int, dtype=np.float32, seed: int = 0
) -> np.ndarray:
    """Grid-shaped RHS slab: the ``poisson_system`` recipe on real rows
    (flat index over the ORIGINAL grid), zero on the padded plane."""
    d = len(grid)
    g0 = grid[0]
    strides = np.cumprod((1,) + tuple(grid[:0:-1]))[::-1]  # row-major strides
    coords = [np.arange(lo, hi, dtype=np.int64).reshape((-1,) + (1,) * (d - 1))]
    for ax in range(1, d):
        shp = [1] * d
        shp[ax] = grid[ax]
        coords.append(np.arange(grid[ax], dtype=np.int64).reshape(shp))
    i = sum(coords[ax] * int(strides[ax]) for ax in range(d)).astype(np.float64)
    vals = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return np.where(coords[0] < g0, vals, 0.0).astype(dtype)


def _assemble(mesh: Mesh, axis: str, padded: GridShape, real0: int, shifts, legs_fn, b_fn,
              dtype):
    """``(A, b, x0)``: A a ``SlabStencil`` and b, x0 ``Shards`` of equal
    axis-0 blocks, slab by slab: ``legs_fn(lo, hi)`` / ``b_fn(lo, hi)``
    make shard i's host slab, which is copied into its device's
    zero-haloed leg slab (halo 1) or vector and dropped before the next
    shard's is made; a process makes its owned shards' alone."""
    num = mesh.shape[axis]
    n0 = padded[0] // num
    local = (n0,) + tuple(padded[1:])
    dt = torch_dtype(dtype)
    slabs, legs, bs, x0s = [], [], [], []
    for i, dev in mesh.shards():
        lo, hi = i * n0, (i + 1) * n0
        host = legs_fn(lo, hi)
        slab, mid = zero_halo_slab(len(shifts), local, 1, dt, dev)
        mid.copy_(torch.from_numpy(host))
        del host
        slabs.append(slab)
        legs.append(mid)
        host = b_fn(lo, hi)
        bs.append(torch.from_numpy(host).to(dev))
        del host
        x0s.append(torch.zeros(local, dtype=dt, device=dev))
    A = SlabStencil(Shards(legs, mesh), shifts, padded, Shards(slabs, mesh), 1, real0)
    return A, Shards(bs, mesh), Shards(x0s, mesh)


def make_rung5_system(
    grid: GridShape, mesh: Mesh, axis: str = "x", dtype=np.float32, seed: int = 0
):
    """Sharded Poisson fine system: returns ``(A, b, x0, padded_grid,
    n_real)`` where ``A`` is a ``SlabStencil`` whose legs are a ``Shards``
    of axis-0 blocks ``(nlegs, G0 / num, *grid[1:])`` and ``b``, ``x0`` are
    ``Shards`` of grid blocks, assembled slab by slab, never globally.
    Axis 0 is identity-padded up to a multiple of the mesh size
    (``A.real0`` is its real extent, ``grid[0]``)."""
    grid = tuple(int(n) for n in grid)
    num = mesh.shape[axis]
    g0 = grid[0]
    G0 = ((g0 + num - 1) // num) * num
    padded = (G0,) + grid[1:]
    A, b, x0 = _assemble(
        mesh, axis, padded, g0, unit_shifts(len(grid)),
        lambda lo, hi: poisson_stencil_slab(grid, lo, hi, dtype=dtype),
        lambda lo, hi: poisson_rhs_slab(grid, lo, hi, dtype=dtype, seed=seed), dtype)
    return A, b, x0, padded, int(np.prod(grid))


def make_convection_system(
    grid: GridShape,
    mesh: Mesh,
    eps: float = 0.05,
    velocity="recirculating",
    scheme: str = "upwind",
    axis: str = "x",
    dtype=np.float32,
    seed: int = 0,
):
    """Sharded convection-diffusion fine system for the nonsymmetric rung-5
    path: ``(A, b, x0)`` as ``make_rung5_system``'s, assembled slab by
    slab from ``core.generators.convection_diffusion_level_slab`` (level
    0) and ``convection_diffusion_rhs_slab``.

    Even extents only (checked): they divide the mesh with no identity
    padding and halve cleanly under the cell-centred transfers of the
    rediscretized hierarchy (``precond.distributed.build_hierarchy_redisc``);
    Galerkin coarsening diverges on this operator family, so the probed
    builder is not an option here."""
    grid = tuple(int(n) for n in grid)
    num = mesh.shape[axis]
    if grid[0] % num:
        raise ValueError(f"grid[0]={grid[0]} must divide the mesh ({num})")
    if any(n % 2 for n in grid):
        raise ValueError(f"even extents required for cc coarsening, got {grid}")
    from conjugategradient_tpu_torch.core.generators import (
        convection_diffusion_level_slab,
        convection_diffusion_rhs_slab,
    )

    slab = convection_diffusion_level_slab(eps, velocity=velocity, scheme=scheme, dtype=dtype)
    return _assemble(
        mesh, axis, grid, grid[0], unit_shifts(len(grid)), lambda lo, hi: slab(0, grid, lo, hi),
        lambda lo, hi: convection_diffusion_rhs_slab(grid, lo, hi, dtype=dtype, seed=seed),
        dtype)


def _fine(hierarchy):
    """The fine product, the V-cycle over a ``ShardHierarchy``, the row
    count and the cycle's ``ShardPlan``: the product is the hierarchy's
    level-0 ``HaloStencil`` with buffers of its own (the same extended
    legs, no second copy).  On an identity-padded grid (axis 0's real
    extent ``hierarchy.real0`` below the grid's) the cycle's output is set
    to exactly 0 on the padded plane by a select (0 * NaN would be NaN), so
    the iterates stay 0 there."""
    if not hierarchy.levels:
        raise ValueError(
            "hierarchy has no sharded level (grid <= max_coarse, or its fine "
            "level does not shard): lower max_coarse or solve on one device")
    grid, mesh = hierarchy.grid, hierarchy.mesh
    M = make_shard_vcycle(None, grid, mesh, axis=mesh.axis, hierarchy=hierarchy)
    n = int(np.prod(grid))
    if hierarchy.real0 >= grid[0]:
        return M.op, M, n, M.plan
    n0 = grid[0] // mesh.size
    bcast = (n0,) + (1,) * (len(grid) - 1)
    keep = Shards([(torch.arange(n0, device=dv) + i * n0 < hierarchy.real0).reshape(bcast)
                   for i, dv in mesh.shards()], mesh)
    return M.op, lambda r: torch.where(keep, M(r), 0.0), n, M.plan


def make_rung5_mg_nonsym(policy, hierarchy, method: str = "bicgstab", restart: int = 32):
    """Sharded multigrid-preconditioned nonsymmetric solve at rung-5 scale:
    ``solve(b, x0) -> CGResult``, ``shard_nonsym.run_sharded_loop`` of
    ``method`` (bicgstab, gmres, fgmres) with the sharded V-cycle over the
    (rediscretized) ``hierarchy`` as right preconditioner; the fine
    operator is the hierarchy's level-0 legs (``solve.plan``: the cycle's
    ``ShardPlan``)."""
    if method not in ("bicgstab", "gmres", "fgmres"):
        raise ValueError(f"unknown method {method!r}")
    op, M, n, plan = _fine(hierarchy)

    def solve(b: Shards, x0: Shards):
        return run_sharded_loop(method, op, M, b, x0, policy, n, restart=restart)

    solve.plan = plan
    return solve


def make_rung5_cg(policy):
    """Sharded plain CG: ``solve(A, b, x0) -> CGResult`` over the
    ``Shards`` of ``make_rung5_system`` (``sharded_cg_loop`` on
    ``A.op()``, kernel #3 a shard on the assembly's slabs; the iteration cap from
    the padded row count).  The padded plane's residual is 0 and stays 0,
    so its rows of the solution come back exactly 0."""

    def solve(A: SlabStencil, b: Shards, x0: Shards):
        return sharded_cg_loop(A.op(), lambda r: r, b, x0, policy, A.n)

    return solve


def make_rung5_mgcg(policy, hierarchy):
    """Sharded MGCG: ``solve(b, x0) -> CGResult``.  The fine operator is
    the hierarchy's level-0 legs (no second copy of them); the probed
    hierarchy (``precond.distributed.build_hierarchy_probed``) is the
    V-cycle's, taken as it is (``solve.plan``: its ``ShardPlan``).  The
    padded plane of each V-cycle's output is set to 0, so the solution is
    exactly 0 there (the JAX package's cycle carries corrections into it,
    which converge to 0 with the rest)."""
    op, M, n, plan = _fine(hierarchy)

    def solve(b: Shards, x0: Shards):
        return sharded_cg_loop(op, M, b, x0, policy, n)

    solve.plan = plan
    return solve
