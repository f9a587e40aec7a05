"""Multi-RHS CG: solve A X = B for k right-hand sides at once.

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

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, DiaMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda
from conjugategradient_tpu_torch.ops.stencil import spmm_columns
from conjugategradient_tpu_torch.solvers.cg import _safe_div
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class MultiCGResult:
    x: torch.Tensor  # (n, k)
    iterations: torch.Tensor  # (k,) int32 per-column iteration counts
    residual: torch.Tensor  # (k,) final residuals (selected norm)
    converged: torch.Tensor  # (k,) bool


def _as_multi_operator(A, device):
    """A (k, n) -> (k, n) operator: kernel #5 for a DIA matrix, the stencil
    SpMM (kernel #1 or #3 per column) for a stencil, a transposed call for an
    (n, k) callable."""
    if isinstance(A, (DiaMatrix, StencilMatrix)) and not torch.is_tensor(A.data):
        A = A.device_put(device=device)
    if isinstance(A, DiaMatrix):
        return lambda P: spmm_dia_cuda(A, P)
    if isinstance(A, (StencilMatrix, ConstStencilMatrix)):
        return lambda P: spmm_columns(A, P)
    if callable(A):
        return lambda P: A(P.T).T.contiguous()
    raise NotImplementedError(
        f"multi-RHS SpMM of {type(A).__name__} is not ported yet "
        "(ROADMAP queue 1: other formats and ingestion)"
    )


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


def bicgstab_solve_multi(*args, **kwargs):
    """Multi-RHS BiCGStab is not ported yet."""
    raise NotImplementedError(
        "bicgstab_solve_multi is not ported yet (ROADMAP queue 1: solver families)"
    )


def cg_solve_multi(
    A,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M=None,
    use_pallas: bool = False,
) -> MultiCGResult:
    """Solve A X = B, ``B`` of shape (n, k), on ``B``'s device.

    Per-column convergence policy (same tol and norm for all columns); the
    loop exits when every column is converged or at max_iteration.  ``A`` is
    a ``DiaMatrix`` (kernel #5 on a CUDA tensor, its twin on a CPU one), a
    ``StencilMatrix`` or ``ConstStencilMatrix`` (``ops.stencil.spmm_columns``)
    or an (n, k) -> (n, k) callable; ``M`` is an optional (n, k) -> (n, k)
    preconditioner (``as_multi_preconditioner`` for MGCG).  ``use_pallas`` is kept for parity and changes nothing
    (see ``ops.spmv.as_operator``).
    """
    n, k = B.shape
    dtype = B.dtype
    dev = B.device
    op = _as_multi_operator(A, dev)
    M_work = None if M is None else (lambda R: M(R.T).T.contiguous())
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    cdot = lambda U, V: torch.sum(U * V, dim=1)
    cexp = lambda s: s[:, None]

    Bt = B.T.contiguous()
    X = torch.zeros_like(Bt) if X0 is None else X0.to(dtype).T.contiguous()
    R = Bt - op(X)
    Z = M_work(R) if M_work is not None else R
    P = Z
    rz = cdot(R, Z)
    rr = cdot(R, R)
    rr0 = rr
    it = torch.zeros(k, dtype=torch.int32, device=dev)

    def res_of(R, rr):
        if policy.norm == "l2":
            return torch.sqrt(rr)
        if policy.norm == "linf":
            return torch.amax(torch.abs(R), dim=1)
        if policy.norm == "rel_l2":
            return torch.sqrt(rr / torch.where(rr0 == 0, torch.ones_like(rr0), rr0))
        raise ValueError(policy.norm)

    def active_of(R, rr, it):
        return ((it < min_iter) | (res_of(R, rr) >= tol)) & (it < max_iter)

    while True:
        active = active_of(R, rr, it)
        if not bool(active.any()):
            break
        AP = op(P)
        zero = torch.zeros_like(rz)
        alpha = torch.where(active, _safe_div(rz, cdot(P, AP)), zero)
        X = X + cexp(alpha) * P
        R2 = R - cexp(alpha) * AP
        Z2 = M_work(R2) if M_work is not None else R2
        rz2 = cdot(R2, Z2)
        rr2 = cdot(R2, R2)
        beta = torch.where(active, _safe_div(rz2, rz), zero)
        P = torch.where(cexp(active), Z2 + cexp(beta) * P, P)
        rz = torch.where(active, rz2, rz)
        rr = torch.where(active, rr2, rr)
        R = torch.where(cexp(active), R2, R)
        it = it + active.to(torch.int32)
    res = res_of(R, rr)
    converged = (res < tol) & (it >= min_iter)
    return MultiCGResult(x=X.T.contiguous(), iterations=it, residual=res, converged=converged)
