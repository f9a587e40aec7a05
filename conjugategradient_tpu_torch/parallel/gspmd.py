"""The GSPMD carriers: MGCG, the multigrid-preconditioned nonsymmetric
solves and fp64 refinement over a mesh, as explicit collectives.

The port of ``conjugategradient_tpu/parallel/gspmd.py``.  The JAX package
writes the whole MGCG program on global shapes, declares the data's
sharding, and lets XLA's SPMD partitioner derive the per-device program:
every level whose grid divides the mesh runs sharded, the rest replicated.
PyTorch has no SPMD partitioner, so the port carries those semantics with
the explicit pieces of ``parallel.shard_mgcg``:

- the levels that ``parallel.mesh.specs_for_grid`` shards (each sharded
  axis divides the mesh) and that ``shard_mgcg._shardable`` can carry
  (even local extents, agg/hyb transfers, or semicoarsening that leaves
  the sharded axes alone) run on blocks: ``HaloStencil`` products on
  kernel #3 and the sharded transfers;
- the levels below run in the replicated tail (the single-device
  ``v_cycle`` once, on the mesh's first device);
- when the fine grid does not divide the mesh (every odd 2^k - 1 grid) GSPMD
  replicates everything, and the port runs ``precond.multigrid.mgcg_solve``
  once on the mesh's first device: on one card exactly the single-device
  solve (kernels #1, #2, #3).

``make_gspmd_mg_nonsym`` carries ``mg_bicgstab``, ``mg_gmres``,
``mg_fgmres`` and ``mg_idr`` (Jacobi smoothing by default, the
rediscretized ``coarse_operator=`` levels that convection needs) the same
way: where the fine grid shards (an even 2^k grid, whose hybrid
cell-centred transfers keep every level dividing the mesh), the sharded
Krylov loop of ``parallel.shard_nonsym`` runs with the sharded V-cycle of
``shard_mgcg.make_shard_vcycle`` as its right preconditioner; where it
does not (every odd fw grid), the single-device solve runs on the mesh's
first device, its product the fine level's stencil (kernel #1 or #3).

``axes`` names the mesh's axes, one per sharded grid axis: ``("x",)`` over
a 1-D mesh shards axis-0 row blocks, ``("x", "y")`` over a 2-D mesh the
JAX package's 2-D block partition (grid axes 0 and 1 over the mesh's two
axes; each sharded level's ``HaloStencil`` exchanges faces on both axes,
the cell-centred transfers cross shards on both).  A level that shards
on one axis but not the other goes to the replicated tail, where GSPMD
would replicate only that axis: the result is the same to reduction
rounding.

``gspmd_refined_solve`` has no double-float arithmetic: the JAX package's
``ops.dd`` stands in for fp64 on the TPU, and the H100 has fp64.  Its outer
fp64 residual runs per shard: on the fine DIA through ``parallel.halo.
HaloDia`` (kernel #4's fp64 instantiation) over row blocks, and on the fine
stencil through a 2-D ``HaloStencil`` (kernel #3's fp64 instantiation)
over 2-D blocks, whose rows are not contiguous.  Its inner solve is
``make_gspmd_mgcg`` in fp32, and ``solvers.refine.run_device_refinement``
drives the passes, reading three scalars each, the solution gathered once
at the end.

Left out: the ``_jit_*`` caches of compiled programs, which eager PyTorch
does not need.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, dia_to_stencil, to_host, torch_dtype
from conjugategradient_tpu_torch.core.generators import LinearSystem
from conjugategradient_tpu_torch.ops.spmv import spmv_dia
from conjugategradient_tpu_torch.parallel.halo import HaloDia, HaloStencil
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    make_mesh,
    pmax,
    psum,
    shard_blocks,
    shard_rows,
    specs_for_grid,
)
from conjugategradient_tpu_torch.parallel.shard_mgcg import (
    _shardable,
    make_shard_mgcg,
    make_shard_vcycle,
)
from conjugategradient_tpu_torch.parallel.shard_nonsym import run_sharded_loop
from conjugategradient_tpu_torch.precond.amg import _np_dtype
from conjugategradient_tpu_torch.precond.multigrid import (
    as_preconditioner,
    build_hierarchy,
    mgcg_solve,
)
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

def _mesh_axes(mesh: Mesh, axes, axis=None) -> Tuple[str, ...]:
    """The carriers' ``axes`` (``axis``: the JAX signature's one-name
    alias), checked against the mesh's own names."""
    mesh.one_process("the GSPMD carriers")
    return mesh.check_axes((axis,) if axis is not None else axes)


def shard_system(system: LinearSystem, mesh: Mesh, axis: str = "x", dtype=None):
    """``(A, b, x0)`` placed on the mesh: A's DIA data, b and x0 as row
    blocks (``Shards``) where the length divides the mesh axis, else the
    whole value on the mesh's first device (the JAX package replicates
    it; here the replicated solve runs there)."""
    mesh.one_process("shard_system")
    num = mesh.shape[axis]
    dt = torch_dtype(dtype if dtype is not None else np.asarray(system.A.data).dtype)

    def put(v, dim):
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        if t.shape[dim] % num == 0:
            return shard_rows(mesh, t, dt, dim=dim)
        return t.to(device=mesh.local_devices[0], dtype=dt)

    A = DiaMatrix(put(system.A.data, -1), system.A.offsets, system.A.shape)
    return A, put(system.b, 0), put(system.x0, 0)


def _shard_hierarchy_and_fine(h, grid, mesh: Mesh, axes) -> bool:
    """Whether the solve runs sharded: the fine grid shards under
    ``specs_for_grid`` and ``shard_mgcg._shardable`` can carry its level on
    every axis of the mesh (otherwise the whole solve replicates, as
    GSPMD's does).  The JAX function places the hierarchy and returns the
    fine operator as well; here ``make_shard_mgcg`` splits the hierarchy at
    its deepest shardable level and places the sharded levels and the
    tail."""
    return (bool(h.levels) and specs_for_grid(tuple(grid), mesh, axes).sharded
            and _shardable(h.levels[0], mesh.dims))


def make_gspmd_mgcg(
    system: LinearSystem,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axes=("x",),
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy=None,
    axis: str = None,
):
    """Build the mesh-partitioned MGCG solver.

    Returns ``(solve, (b, x0))``: ``solve(b, x0) -> CGResult`` with a flat
    global x on the mesh's first device, and the system's vectors placed
    for it.  Where the fine grid shards (``specs_for_grid`` over ``axes``,
    one axis name), ``solve`` is ``shard_mgcg``'s over the sharded levels
    and the replicated tail; otherwise it is ``mgcg_solve`` on the mesh's
    first device.  ``solve.n_sharded`` is the split (0: replicated).  The
    hierarchy is built on the mesh's first device unless given."""
    axes = _mesh_axes(mesh, axes, axis)
    grid = tuple(grid)
    dt = _np_dtype(dtype if dtype is not None else np.asarray(system.A.data).dtype)
    h = hierarchy or build_hierarchy(system.A, grid, smoother=smoother, pre=pre, post=post,
                                     dtype=dt, layout="stencil", device=mesh.local_devices[0])
    if _shard_hierarchy_and_fine(h, grid, mesh, axes):
        solve, inputs = make_shard_mgcg(system, grid, mesh, policy, axis=mesh.axis, dtype=dt,
                                        hierarchy=h)
        solve.n_sharded = solve.plan.n_sharded
        return solve, inputs

    dev = mesh.local_devices[0]

    def place(v):
        t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
        return t.to(device=dev, dtype=torch_dtype(dt))

    def solve(b, x0) -> CGResult:
        return mgcg_solve(system.A, place(b), grid, x0=place(x0), policy=policy, hierarchy=h)[0]

    solve.n_sharded = 0
    return solve, (place(system.b), place(system.x0))


def gspmd_mgcg_solve(
    system: LinearSystem,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    **kw,
) -> CGResult:
    """One-call convenience: place, solve (``mesh``: every visible CUDA
    device by default)."""
    if mesh is None:
        mesh = make_mesh()
    solve, (b, x0) = make_gspmd_mgcg(system, grid, mesh, policy, **kw)
    return solve(b, x0)


#: the Krylov bases of the multigrid-preconditioned nonsymmetric carrier
MG_NONSYM = ("bicgstab", "gmres", "fgmres", "idr")


def _single_device_nonsym(method: str, A, b, x0, policy, M, restart: int, shadow=None):
    """The single-device ``method`` solve with ``M``: the replicated
    carrier."""
    if method == "bicgstab":
        from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

        return bicgstab_solve(A, b, x0, policy, M=M)
    if method == "idr":
        from conjugategradient_tpu_torch.solvers.idr import idr_solve

        return idr_solve(A, b, x0, policy, M=M, shadow=shadow)
    from conjugategradient_tpu_torch.solvers.gmres import fgmres_solve, gmres_solve

    fn = gmres_solve if method == "gmres" else fgmres_solve
    return fn(A, b, x0, policy, M=M, restart=restart)


def make_gspmd_mg_nonsym(
    A: DiaMatrix,
    b,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    axes=("x",),
    smoother: str = "jacobi",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy=None,
    coarse_operator=None,
    restart: int = 32,
    x0=None,
    shadow=None,
    **build_kw,
):
    """The mesh-partitioned multigrid-preconditioned nonsymmetric solve:
    BiCGStab, GMRES, FGMRES or IDR with the V-cycle as right
    preconditioner (the distributed ``mg_bicgstab`` and kin).

    Returns ``(solve, (b, x0))`` with the inputs placed, as
    ``make_gspmd_mgcg``: ``solve(b, x0) -> CGResult`` with a flat global
    x on the mesh's first device.  Where the fine grid shards (an even 2^k
    grid: hybrid cell-centred transfers, every level halving and dividing
    the mesh), the loop is ``shard_nonsym.run_sharded_loop`` on the grid
    blocks of ``axes``, its product the fine level's ``HaloStencil`` (kernel #3 a
    shard) and its ``M`` ``shard_mgcg.make_shard_vcycle``; ``solve.plan``
    is the split.  Otherwise (every odd fw grid, where GSPMD replicates)
    it is the single-device solve on the mesh's first device over the
    fine level's stencil, ``solve.n_sharded`` 0.  ``smoother`` defaults to
    Jacobi, robust at any Peclet number (Chebyshev's bounds come from a
    symmetrized operator); ``coarse_operator`` rediscretizes the coarse
    levels, as convection-dominated operators need.  ``shadow`` is IDR's
    global ``(n, s)`` draw (default: the port's seeded one; the JAX
    package's, carried across by ``convert.idr_shadow_from_reference``,
    gives its iterates)."""
    if method not in MG_NONSYM:
        raise ValueError(f"unknown method {method!r}; want {'|'.join(MG_NONSYM)}")
    axes = _mesh_axes(mesh, axes)
    grid = tuple(grid)
    n = int(np.prod(grid))
    dt = _np_dtype(dtype if dtype is not None else np.asarray(A.data).dtype)
    tdt = torch_dtype(dt)
    dev = mesh.local_devices[0]
    h = hierarchy or build_hierarchy(A, grid, smoother=smoother, pre=pre, post=post, dtype=dt,
                                     layout="stencil", coarse_operator=coarse_operator,
                                     device=dev, **build_kw)
    as_tensor = lambda v: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    x0 = np.zeros(n) if x0 is None else x0

    if _shard_hierarchy_and_fine(h, grid, mesh, axes):
        M = make_shard_vcycle(A, grid, mesh, mesh.axis, dtype=dt, hierarchy=h)

        def place(v):
            return v if isinstance(v, Shards) else shard_blocks(mesh, as_tensor(v).reshape(grid),
                                                                (0, 1), dt)

        def solve(b_, x0_) -> CGResult:
            res = run_sharded_loop(method, M.op, M, place(b_), place(x0_), policy, n,
                                   restart=restart, shadow=shadow)
            return dataclasses.replace(res, x=res.x.gather_grid(len(grid)).reshape(-1))

        solve.n_sharded = M.plan.n_sharded
        solve.plan = M.plan
        return solve, (place(b), place(x0))

    A0 = (h.levels[0].A if h.levels
          else dia_to_stencil(to_host(A), grid).device_put(tdt, dev))
    M = as_preconditioner(h)

    def place(v):
        return as_tensor(v).to(device=dev, dtype=tdt).reshape(grid)

    def solve(b_, x0_) -> CGResult:
        res = _single_device_nonsym(method, A0, place(b_), place(x0_), policy, M, restart,
                                    shadow)
        return dataclasses.replace(res, x=res.x.reshape(-1))

    solve.n_sharded = 0
    return solve, (place(b), place(x0))


def gspmd_mg_nonsym_solve(
    A: DiaMatrix,
    b,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    **kw,
) -> CGResult:
    """One-call convenience for the multigrid-preconditioned nonsymmetric
    solve over a mesh (every visible CUDA device by default)."""
    if mesh is None:
        mesh = make_mesh()
    solve, (b_dev, x0_dev) = make_gspmd_mg_nonsym(A, b, grid, mesh, policy, **kw)
    return solve(b_dev, x0_dev)


def gspmd_refined_solve(
    A: DiaMatrix,
    b,
    grid,
    mesh: Optional[Mesh] = None,
    axes=("x",),
    x0=None,
    tol: float = 1e-8,
    norm: str = "l2",
    inner_tol: float = 1e-5,
    max_outer: int = 40,
    hierarchy=None,
    smoother: str = "chebyshev",
    raise_on_divergence: bool = False,
):
    """fp64-tolerance refinement over a mesh: the reference's absolute-1e-8
    contract (``Mgcg/cuBlas/Mgcg/MgcgMain.cs:29``) at distributed scale.

    Two pieces over the same mesh, so nothing reshards between them: the
    fp64 outer pass (residual, its norm squared and max-abs, the scaling
    and the update) on the mesh's blocks, with ``b - A x`` on kernel #4
    per shard over row blocks (``HaloDia`` over the host fp64 DIA ``A``)
    or on kernel #3 per shard over the 2-D blocks of ``axes=("x", "y")``
    (a ``HaloStencil`` of A's fine stencil in fp64), and the fp32 inner
    solve ``make_gspmd_mgcg``.  Per outer pass three scalars reach
    the host (r.r and max|r| in one read, and the inner count); the
    solution is gathered once, at the end.  Where the fine grid does not
    shard, both run on the mesh's first device (kernel #4 on the whole
    DIA).  Returns ``solvers.refine.RefineResult``."""
    from conjugategradient_tpu_torch.solvers.refine import run_device_refinement

    if mesh is None:
        mesh = make_mesh()
    axes = _mesh_axes(mesh, axes)
    grid = tuple(grid)
    n = A.n
    b64 = b if torch.is_tensor(b) else np.asarray(b, dtype=np.float64)
    x64 = np.zeros(n) if x0 is None else x0
    inner_policy = ConvergencePolicy(tol=inner_tol, norm="rel_l2",
                                     max_iteration=min(8 * n, 1_000_000))
    system = LinearSystem(A=A, b=b64, x0=x64)
    solve_inner, _ = make_gspmd_mgcg(system, grid, mesh, inner_policy, axes=axes,
                                     smoother=smoother, dtype=np.float32, hierarchy=hierarchy)
    f64 = torch.float64
    as_tensor = lambda v: v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    read_x = None

    if solve_inner.n_sharded:
        if mesh.ndim == 1:
            # row blocks: the fine DIA on kernel #4 a shard
            op = HaloDia(shard_rows(mesh, A.data, f64, dim=1), tuple(A.offsets), A.bandwidth,
                         A.bandwidth > n // mesh.size)
            local = (grid[0] // mesh.size,) + grid[1:]
            place = lambda v: shard_rows(mesh, as_tensor(v), f64)
        else:
            # 2-D blocks: the fine stencil on kernel #3 a shard (fp64)
            st = dia_to_stencil(to_host(A), grid)
            halos = tuple(max(abs(s_[a]) for s_ in st.shifts) for a in range(2))
            op = HaloStencil(shard_blocks(mesh, st.data, (1, 2), f64), st.shifts, halos)
            local = op.local
            place = lambda v: shard_blocks(mesh, as_tensor(v).reshape(grid), (0, 1), f64)
            read_x = lambda x_: x_.gather_grid(len(grid)).reshape(-1).cpu().numpy()
        zero32 = Shards([torch.zeros(local, dtype=torch.float32, device=d)
                         for d in mesh.local_devices], mesh)

        def resid(b_, x_):
            r = b_ - op(x_)
            mx = pmax(Shards.map(lambda t: t.abs().max(), r)).parts[0]
            rr = psum(Shards.map(lambda t: torch.dot(t.reshape(-1), t.reshape(-1)), r)).parts[0]
            s = torch.where(mx > 0, mx, torch.ones_like(mx))
            return (r / s).to(torch.float32).reshape(local), rr, mx

        def update(x_, r32, s):
            d = solve_inner.shards(r32, zero32)
            return x_ + s * d.x.reshape(x_.shape).to(f64), d.iterations

        b_dev, x_dev = place(b64), place(x64)
    else:
        dev = mesh.local_devices[0]
        A64 = A.device_put(f64, dev)
        zero32 = torch.zeros(grid, dtype=torch.float32, device=dev)

        def resid(b_, x_):
            r = b_ - spmv_dia(A64, x_)
            mx = torch.max(torch.abs(r))
            s = torch.where(mx > 0, mx, torch.ones_like(mx))
            return (r / s).to(torch.float32).reshape(grid), torch.dot(r, r), mx

        def update(x_, r32, s):
            d = solve_inner(r32, zero32)
            return x_ + s * d.x.reshape(-1).to(f64), d.iterations

        place = lambda v: as_tensor(v).to(device=dev, dtype=f64).reshape(n)
        b_dev, x_dev = place(b64), place(x64)

    return run_device_refinement(resid, update, b_dev, x_dev, tol=tol, norm=norm,
                                 max_outer=max_outer, raise_on_divergence=raise_on_divergence,
                                 to_host=read_x)
