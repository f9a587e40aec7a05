"""Multi-RHS CG and BiCGStab: solve A X = B for k right-hand sides at once.

One SpMM pass serves k Krylov recurrences, so the matrix stream is shared by
all columns.  Each column runs its own scalar recurrence (columnwise alphas
and betas); a column that has converged (or hit max_iteration) freezes under
masked updates until every column is done.

The Krylov state is held as ``(k, n)``, each column contiguous, for the
whole solve: the layout kernel #5 (``ops.cuda_dia.spmm_dia_cuda``) reads,
and the one ``ops.stencil.spmm_columns`` cuts a stencil's columns from.
``B`` is transposed once at entry and ``X`` once at exit (the JAX package's
``make_cm_operator`` lesson: convert the layout twice per solve, not per
SpMM).  Like ``cg_solve`` this is a Python loop; the host reads one device
scalar per iteration (whether any column is still active).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from conjugategradient_tpu_torch.core.formats import (
    BsrMatrix,
    ConstStencilMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    StencilMatrix,
)
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda
from conjugategradient_tpu_torch.ops.spmm import spmm
from conjugategradient_tpu_torch.ops.spmv import prepare
from conjugategradient_tpu_torch.ops.stencil import spmm_columns
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_block
from conjugategradient_tpu_torch.solvers.cg import cg_block, columns_dot, columns_linf
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class MultiCGResult:
    x: torch.Tensor  # (n, k)
    iterations: torch.Tensor  # (k,) int32 per-column iteration counts
    residual: torch.Tensor  # (k,) final residuals (selected norm)
    converged: torch.Tensor  # (k,) bool


def _as_multi_operator(A, device):
    """A (k, n) -> (k, n) operator: kernel #5 for a DIA matrix, the stencil
    SpMM (kernel #1 or #3 per column) for a stencil, ``ops.spmm`` on the
    transposed block for every other container, a transposed call for an
    (n, k) callable.  ``ops.spmv.prepare`` places a host container on
    ``device`` first and sorts a COO matrix into its CSR once."""
    A = prepare(A, device)
    if isinstance(A, DiaMatrix):
        return lambda P: spmm_dia_cuda(A, P)
    if isinstance(A, (StencilMatrix, ConstStencilMatrix)):
        return lambda P: spmm_columns(A, P)
    if isinstance(A, (CsrMatrix, EllMatrix, BsrMatrix, DenseMatrix)):
        return lambda P: spmm(A, P.T).T.contiguous()
    if callable(A):
        return lambda P: A(P.T).T.contiguous()
    raise TypeError(f"unsupported matrix type {type(A)}")


def as_multi_preconditioner(h):
    """Multi-RHS V-cycle: M mapping (n, k) -> (n, k), one V-cycle per
    column, which is what the JAX package's ``vmap`` of ``v_cycle``
    computes.  Plug into ``cg_solve_multi(..., M=...)`` for multi-RHS MGCG.

    The columns are cut contiguous from a ``(k, n)`` copy of ``R``, which
    costs nothing when ``R`` is the transpose of ``cg_solve_multi``'s
    ``(k, n)`` state, and each runs the single-RHS cycle: kernels #1, #2 and
    #3 launch per column exactly as in MGCG.  Like ``as_preconditioner`` it
    turns TF32 off for the coarse dense product."""
    from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner

    cycle = as_preconditioner(h)

    def M(R):
        Rk = R.T.contiguous()
        return torch.stack([cycle(Rk[j]) for j in range(Rk.shape[0])]).T

    return M


def bicgstab_solve_multi(
    A,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M=None,
    use_pallas: bool = False,
    psum_axis: Optional[str] = None,
    n_global: Optional[int] = None,
) -> MultiCGResult:
    """Multi-RHS BiCGStab: solve A X = B for a nonsymmetric ``A``, ``B`` of
    shape (n, k), on ``B``'s device; the nonsymmetric twin of
    ``cg_solve_multi``, whose ``psum_axis`` and ``n_global`` it takes.

    One SpMM serves the k recurrences per half-step (two per iteration, as
    the single-RHS form's two products): kernel #5 for a DIA matrix,
    ``ops.spmm`` for the other containers.  Each column runs its own scalar
    recurrence (columnwise rho, alpha, omega), ``_safe_div`` keeps a
    column's breakdown from poisoning the block, and a converged column
    freezes under masked updates.  ``M`` is an optional linear (n, k) ->
    (n, k) right preconditioner (``as_multi_preconditioner`` for the
    V-cycle).  ``use_pallas`` is kept for parity and changes nothing.
    """
    op, hooks = _block_setup(A, B, psum_axis, n_global)
    M_work = None if M is None else (lambda R: M(R.T).T.contiguous())
    X = None if X0 is None else X0.to(B.dtype).T.contiguous()
    X, it, res, converged = bicgstab_block(op, B.T.contiguous(), X, policy, M_work, **hooks)
    return MultiCGResult(x=X.T.contiguous(), iterations=it, residual=res, converged=converged)


def _block_setup(A, B, psum_axis, n_global):
    """(op, the block loop's sharded hooks): with ``psum_axis`` the
    shards' own operator and the (k,) dots and max-abs norms through one
    ``psum``/``pmax`` each; otherwise ``_as_multi_operator`` and no
    hooks."""
    if psum_axis is None:
        return _as_multi_operator(A, B.device), {}
    from conjugategradient_tpu_torch.parallel.mesh import Shards, pmax, psum

    if not isinstance(B, Shards) or B.mesh.axis != psum_axis:
        raise ValueError(f"psum_axis={psum_axis!r} takes B as Shards of a mesh over that axis")
    hooks = dict(dot=lambda U, V: psum(Shards.map(columns_dot, U, V)).parts[0],
                 linf=lambda R: pmax(Shards.map(columns_linf, R)).parts[0], n_global=n_global)
    return A, hooks


def cg_solve_multi(
    A,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M=None,
    use_pallas: bool = False,
    psum_axis: Optional[str] = None,
    n_global: Optional[int] = None,
) -> MultiCGResult:
    """Solve A X = B, ``B`` of shape (n, k), on ``B``'s device.

    Per-column convergence policy (same tol and norm for all columns); the
    loop exits when every column is converged or at max_iteration.  ``A`` is
    a ``DiaMatrix`` (kernel #5 on a CUDA tensor, its twin on a CPU one), a
    ``StencilMatrix`` or ``ConstStencilMatrix`` (``ops.stencil.spmm_columns``),
    any other container (``ops.spmm``) or an (n, k) -> (n, k) callable; ``M`` is an optional (n, k) -> (n, k)
    preconditioner (``as_multi_preconditioner`` for MGCG).  ``use_pallas`` is kept for parity and changes nothing
    (see ``ops.spmv.as_operator``).

    ``psum_axis`` runs the same loop on row shards, as the JAX package's
    does inside ``shard_map``: ``B`` (and ``X0``) are then
    ``parallel.mesh.Shards`` of (n_local, k) row blocks of a mesh over that
    axis, ``A`` the shards' operator on the loop's ``(k, n_local)`` layout
    (with its halo collectives inside: ``parallel.halo.HaloDia``), and
    every per-column dot is ONE (k,) ``psum`` (the max-abs norm one
    ``pmax``).  ``n_global`` is the system's size for the max-iteration
    policy.  See ``parallel.shard_multi.sharded_cg_multi_solve``.
    """
    op, hooks = _block_setup(A, B, psum_axis, n_global)
    dot = hooks.get("dot", columns_dot)
    M_work = None if M is None else (lambda R: M(R.T).T.contiguous())
    X = None if X0 is None else X0.to(B.dtype).T.contiguous()

    def op_dot(P):
        AP = op(P)
        return AP, dot(P, AP)

    X, it, res, converged = cg_block(op, op_dot, B.T.contiguous(), X, policy, M_work, **hooks)
    return MultiCGResult(x=X.T.contiguous(), iterations=it, residual=res, converged=converged)
