"""Explicit-collective multi-RHS solves: block CG over row shards.

The port of ``conjugategradient_tpu/parallel/shard_multi.py``: the sharded
forms of ``solvers.multi``, on the single-controller mesh of
``parallel.mesh``.

- ``make_shard_multi_mgcg``: multi-RHS MGCG on the sharded V-cycle of
  ``parallel.shard_mgcg``.  The port holds k columns leading, a shard's
  ``(k, n0, *rest)`` block (the JAX package's are ``(n0, *rest, k)``): each
  column stays contiguous for kernel #3, which runs once a column a shard
  per product (``spmm_stencil_shard``, as the single-device
  ``ops.stencil.spmm_columns`` does), while one ``ppermute`` pair moves the
  halo slabs of all k columns.  ``shard_mgcg``'s transfers act on the
  trailing grid dims, so the columns ride through them (the JAX package's
  ``_restrict_agg_multi``, ``_prolong_agg_multi``, ``_restrict_fw_multi``
  and ``_prolong_fw_multi`` are those functions), and the replicated tail
  runs the single-device ``v_cycle`` a column at a time, once, on the
  first shard's device.
- ``sharded_cg_multi_solve``: block CG or BiCGStab on a flat DIA, each
  shard's ``(k, n_local)`` block through kernel #5 (``spmm_dia_cuda``) on
  its rows as a square DIA with zero halo rows (``parallel.halo.HaloDia``),
  one launch a shard per block product, one halo pair of ``(k, halo)``
  slabs whatever k is.

The block recurrence is not copied: both run ``solvers.cg.cg_block`` (and
``solvers.bicgstab.bicgstab_block``) with the sharded hooks, every
per-column dot ONE (k,) ``psum`` and the max-abs norm one ``pmax``;
converged columns freeze under masked updates, as in ``cg_solve_multi``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, torch_dtype
from conjugategradient_tpu_torch.parallel.halo import HaloDia, HaloStencil
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, make_mesh, pmax, psum, shard_rows
from conjugategradient_tpu_torch.parallel.shard_mgcg import (
    _plan,
    _prep_shard_hierarchy,
    make_vcycle,
)
from conjugategradient_tpu_torch.precond.amg import _np_dtype
from conjugategradient_tpu_torch.precond.multigrid import MgHierarchy
from conjugategradient_tpu_torch.solvers.cg import cg_block, columns_dot, columns_linf
from conjugategradient_tpu_torch.solvers.multi import (
    MultiCGResult,
    bicgstab_solve_multi,
    cg_solve_multi,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def spmm_stencil_shard(legs: Shards, shifts, X: Shards, halo0: int) -> Shards:
    """Local rows of a stencil SpMM on axis-0 row blocks: each shard's k
    columns ``(k, n0, *rest)`` (and ``(L, n0, *rest)`` legs), one
    ``ppermute`` pair of ``(k, halo0, *rest)`` slabs, kernel #3 on each
    column's extended slab."""
    return HaloStencil(legs, shifts, halo0)(X)


def _pdot(U: Shards, V: Shards) -> torch.Tensor:
    """The (k,) column dots of two row-sharded ``(k, n_local)`` blocks: one
    ``psum``, read on the first shard's device."""
    return psum(Shards.map(columns_dot, U, V)).parts[0]


def _plinf(R: Shards) -> torch.Tensor:
    return pmax(Shards.map(columns_linf, R)).parts[0]


def make_shard_multi_mgcg(
    system,
    B,
    grid,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    dtype=None,
    hierarchy: Optional[MgHierarchy] = None,
):
    """Build an explicit-collective multi-RHS MGCG solver.

    ``B`` is ``(n, k)`` (host array or tensor).  Returns ``(solve, (B_sh,
    X0_sh))`` with ``solve(B_sh, X0_sh) -> MultiCGResult`` (x of shape
    ``(n, k)`` on the mesh's first device) and ``B_sh``, ``X0_sh`` (zeros)
    the blocks placed as ``Shards`` of each shard's ``(k, n_local)`` rows
    (``place(X)`` on the solve places another (n, k) block).  ``system``
    gives ``A`` (host fp64 DIA); the hierarchy is built on the mesh's first
    device unless given.  ``solve.plan`` is the V-cycle's ``ShardPlan``."""
    mesh.one_process("make_shard_multi_mgcg")
    grid = tuple(grid)
    d = len(grid)
    dt = _np_dtype(dtype if dtype is not None else np.asarray(system.A.data).dtype)
    tdt = torch_dtype(dt)
    Bt = B if torch.is_tensor(B) else torch.from_numpy(np.asarray(B))
    n, k = Bt.shape
    if n != int(np.prod(grid)):
        raise ValueError(f"B rows {n} != prod(grid) {int(np.prod(grid))}")
    h, n_sharded, levels, rep_h = _prep_shard_hierarchy(system.A, grid, mesh, axis, smoother, pre,
                                                        post, dt, hierarchy)
    local = tuple(levels[0].op.local)
    cycle = make_vcycle(h, levels, rep_h, d)
    op_grid = levels[0].op.sibling()
    op = lambda P: op_grid(P.reshape((P.shape[0],) + local)).reshape(P.shape[0], -1)
    M = lambda R: cycle(R.reshape((R.shape[0],) + local)).reshape(R.shape[0], -1)

    def place(X) -> Shards:
        """An (n, k) block as each shard's (k, n_local) rows."""
        if isinstance(X, Shards):
            return X
        t = X if torch.is_tensor(X) else torch.from_numpy(np.asarray(X))
        t = t.to(tdt).T.reshape((t.shape[1],) + grid)
        return shard_rows(mesh, t, tdt, dim=1).reshape(t.shape[0], -1)

    def op_dot(P):
        AP = op(P)
        return AP, _pdot(P, AP)

    def solve(B_sh, X0_sh) -> MultiCGResult:
        X, it, res, conv = cg_block(op, op_dot, place(B_sh), place(X0_sh), policy, M, dot=_pdot,
                                    linf=_plinf, n_global=n)
        return MultiCGResult(x=X.gather(dim=1).T.contiguous(), iterations=it, residual=res,
                             converged=conv)

    solve.place = place
    solve.plan = _plan(levels, rep_h, tdt.itemsize, h.smoother, h.pre, h.post)
    solve.operators = (op_grid,) + tuple(L.op for L in levels)
    return solve, (place(Bt), place(torch.zeros_like(Bt)))


def shard_multi_mgcg_solve(
    system,
    B,
    grid,
    mesh: Optional[Mesh] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    X0=None,
    **kw,
) -> MultiCGResult:
    """One-call convenience: build, place, solve A X = B for all columns
    (``mesh``: every visible CUDA device by default)."""
    if mesh is None:
        mesh = make_mesh()
    solve, (B_sh, X0_sh) = make_shard_multi_mgcg(system, B, grid, mesh, policy, **kw)
    if X0 is not None:
        X0_sh = solve.place(X0)
    return solve(B_sh, X0_sh)


def sharded_cg_multi_solve(
    A,
    B,
    X0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    dtype=None,
    method: str = "cg",
) -> MultiCGResult:
    """Row-block-sharded block CG for a flat DIA matrix, k right-hand sides.

    Each shard's ``(k, n_local)`` block goes through kernel #5 on its rows
    as a square DIA with zero halo rows (``HaloDia``; the all-gather window
    where the bandwidth passes ``n_local``), one halo pair of ``(k, halo)``
    slabs a product; the recurrence is ``cg_solve_multi`` itself with
    ``psum_axis`` (ONE (k,) psum per dot; no third copy of the block
    recurrence).  ``method="bicgstab"`` swaps in ``bicgstab_solve_multi``
    over the same product.  ``A`` is host (or device) DIA, ``B`` and ``X0``
    ``(n, k)``; ``n`` must divide by the shard count
    (``core.partition.pad_system``).  x comes back ``(n, k)`` on the mesh's
    first device."""
    if not isinstance(A, DiaMatrix):
        raise TypeError("sharded_cg_multi_solve wants a DiaMatrix")
    if mesh is None:
        mesh = make_mesh(axis=axis)
    mesh.one_process("sharded_cg_multi_solve")
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    n_local = n // num
    halo = A.bandwidth
    dt = torch_dtype(dtype if dtype is not None else A.data.dtype)
    data = shard_rows(mesh, A.data, dt, dim=1)
    op = HaloDia(data, tuple(A.offsets), halo, halo > n_local)
    B_sh = shard_rows(mesh, B, dt, dim=0)
    X0_sh = (Shards.map(torch.zeros_like, B_sh) if X0 is None
             else shard_rows(mesh, X0, dt, dim=0))
    solver = bicgstab_solve_multi if method == "bicgstab" else cg_solve_multi
    res = solver(op, B_sh, X0_sh, policy, psum_axis=axis, n_global=n)
    return MultiCGResult(x=res.x.gather(), iterations=res.iterations, residual=res.residual,
                         converged=res.converged)
