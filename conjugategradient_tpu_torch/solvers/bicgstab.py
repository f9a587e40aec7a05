"""(Preconditioned) BiCGStab for nonsymmetric systems, on device tensors.

The port of ``conjugategradient_tpu/solvers/bicgstab.py`` (van der Vorst,
SIAM J. Sci. Stat. Comput. 13, 1992): two products and four dots per
iteration, constant memory, no restart parameter.

Preconditioning is right-sided, ``A M^-1 (M x) = b``, applied as
``p_hat = M(p)`` and ``s_hat = M(s)`` inside the recurrence, so the
residual the loop monitors is the true residual of ``A x = b``, and any
linear ``M`` of ``solvers.cg`` (Jacobi, block Jacobi, Chebyshev, a V-cycle,
an AMG cycle) drops in unchanged.

Breakdown (rho -> 0 or t.t -> 0) freezes the affected update through
``_safe_div`` and the returned ``converged`` flag reports the truth, as in
the JAX package.  ``bicgstab_solve`` is a Python loop that reads one device
scalar per iteration (the ``residual >= tol`` half of the predicate);
``bicgstab_solve_traced`` runs ``num_steps`` masked steps with no host
read.  On a CUDA ``b`` a DIA operator runs kernel #4: two launches per
iteration (per group of diagonals) and one for the initial residual.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.ops.cuda_dia import spmv_dia_batched_cuda
from conjugategradient_tpu_torch.solvers.cg import (
    CGResult,
    _apply_M,
    _safe_div,
    _setup,
    block_residual,
    check_batched,
    columns_dot,
    columns_linf,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _init(op, b, x0, dot):
    """(rhat, rr0, state0): the fixed shadow residual (the initial r), its
    r.r and the start of the recurrence, ``state0 = (x, r, p, v, rho,
    alpha, omega, rr)``."""
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    r = b - op(x)
    rr0 = dot(r, r)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    zero = torch.zeros_like(b)
    return r, rr0, (x, r, zero, zero, one, one, one, rr0)


def _make_step(op, M, dot, rhat):
    """THE BiCGStab recurrence, written once: ``step(state) -> state`` with
    ``state = (x, r, p, v, rho, alpha, omega, rr)``."""

    def step(state):
        x, r, p, v, rho, alpha, omega, _rr = state
        rho_new = dot(rhat, r)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = _apply_M(M, p)
        v = op(p_hat)
        alpha = _safe_div(rho_new, dot(rhat, v))
        s = r - alpha * v
        s_hat = _apply_M(M, s)
        t = op(s_hat)
        omega = _safe_div(dot(t, s), dot(t, t))
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        return (x, r, p, v, rho_new, alpha, omega, dot(r, r))

    return step


def bicgstab_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> CGResult:
    """Solve A x = b (A square, possibly nonsymmetric) by right-
    preconditioned BiCGStab on ``b``'s device.

    ``A`` is any container of ``core.formats`` (a host one is placed on
    ``b``'s device) or a callable; ``M`` a fixed linear preconditioner, a
    callable or a ``(fn, state)`` pair (``solvers.cg._apply_M``).
    ``use_pallas`` is kept for parity and changes nothing.  Shape-agnostic
    like ``cg_solve`` (grid-shaped or flat ``b``).
    """
    op, dot = _setup(A, b, precise_dot, use_pallas)
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(b.numel())
    rhat, rr0, state = _init(op, b, x0, dot)
    step = _make_step(op, M, dot, rhat)

    def res_of(state):
        return residual_norm(state[1], state[7], rr0, policy.norm)

    it = 0
    while it < max_iter and (it < min_iter or bool(res_of(state) >= tol)):
        state = step(state)
        it += 1
    res = res_of(state)
    return CGResult(x=state[0], iterations=it, residual=res,
                    converged=bool(res < tol) and it >= min_iter)


def bicgstab_solve_traced(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    num_steps: int = 100,
    precise_dot: bool = False,
    use_pallas: bool = False,
):
    """Fixed-length BiCGStab recording the residual after every iteration,
    the nonsymmetric twin of ``cg_solve_traced``: ``num_steps`` masked
    steps, no host read inside, frozen steps after convergence (selected
    by ``torch.where``, exact), the history in a preallocated
    ``(num_steps,)`` device tensor.  ``max_iteration`` is not applied, as in
    the JAX package.

    Returns ``(CGResult, history)``; entries past ``iterations`` are from
    frozen steps.
    """
    op, dot = _setup(A, b, precise_dot, use_pallas)
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    rhat, rr0, state = _init(op, b, x0, dot)
    step = _make_step(op, M, dot, rhat)

    def res_of(state):
        return residual_norm(state[1], state[7], rr0, policy.norm)

    history = torch.empty(num_steps, dtype=b.dtype, device=b.device)
    it = torch.zeros((), dtype=torch.int32, device=b.device)
    for k in range(num_steps):
        active = (it < policy.min_iteration) | (res_of(state) >= tol)
        new = step(state)
        state = tuple(torch.where(active, a, o) for a, o in zip(new, state))
        it = it + active.to(torch.int32)
        history[k] = res_of(state)
    res = res_of(state)
    iterations = int(it)
    result = CGResult(x=state[0], iterations=iterations, residual=res,
                      converged=bool(res < tol) and iterations >= policy.min_iteration)
    return result, history


def bicgstab_block(op: Callable, B: torch.Tensor, X: Optional[torch.Tensor],
                   policy: ConvergencePolicy, M: Optional[Callable] = None,
                   dot: Callable = columns_dot, linf: Callable = columns_linf,
                   n_global: Optional[int] = None):
    """THE per-row BiCGStab of a ``(k, n)`` block, shared by
    ``bicgstab_solve_multi`` and ``bicgstab_solve_batched``: ``op`` maps a
    ``(k, n)`` block row by row, ``M`` is an optional ``(k, n) -> (k, n)``
    right preconditioner, ``X`` the start (``None``: zeros).  Each row runs
    its own rho, alpha and omega (``_safe_div`` keeps a row's breakdown
    from poisoning the block) and its own ``max_iteration``; a converged row
    freezes under masked updates, and the host reads one device scalar per
    iteration.  Returns ``(X, iterations, residual, converged)``, each with
    the leading k axis.  ``dot``, ``linf`` and ``n_global`` are
    ``cg_block``'s sharded hooks."""
    k, n = B.shape[0], (B.shape[1] if n_global is None else n_global)
    dtype, dev = B.dtype, B.device
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    cdot = dot
    cexp = lambda s: s[:, None]

    X = torch.zeros_like(B) if X is None else X
    R = B - op(X)
    Rhat = R  # a fixed shadow residual per row
    rr = cdot(R, R)
    res_of = block_residual(policy, rr, linf)
    onek = torch.ones(k, dtype=dtype, device=dev)
    Pd, V = torch.zeros_like(R), torch.zeros_like(R)
    rho, alpha, omega = onek, onek, onek
    it = torch.zeros(k, dtype=torch.int32, device=dev)
    while True:
        active = ((it < min_iter) | (res_of(R, rr) >= tol)) & (it < max_iter)
        if not bool(active.any()):
            break
        rho_new = cdot(Rhat, R)
        beta = _safe_div(rho_new, rho) * _safe_div(alpha, omega)
        Pd2 = R + cexp(beta) * (Pd - cexp(omega) * V)
        Phat = M(Pd2) if M is not None else Pd2
        V2 = op(Phat)
        alpha2 = _safe_div(rho_new, cdot(Rhat, V2))
        S = R - cexp(alpha2) * V2
        Shat = M(S) if M is not None else S
        T = op(Shat)
        omega2 = _safe_div(cdot(T, S), cdot(T, T))
        X2 = X + cexp(alpha2) * Phat + cexp(omega2) * Shat
        R2 = S - cexp(omega2) * T
        am = cexp(active)
        X = torch.where(am, X2, X)
        R2 = torch.where(am, R2, R)
        Pd = torch.where(am, Pd2, Pd)
        V = torch.where(am, V2, V)
        rho = torch.where(active, rho_new, rho)
        alpha = torch.where(active, alpha2, alpha)
        omega = torch.where(active, omega2, omega)
        rr = torch.where(active, cdot(R2, R2), rr)
        R = R2
        it = it + active.to(torch.int32)
    res = res_of(R, rr)
    return X, it, res, (res < tol) & (it >= min_iter)


def bicgstab_solve_batched(
    data: torch.Tensor,
    offsets,
    shape,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
) -> CGResult:
    """Solve ``A_j x_j = b_j`` for k nonsymmetric DIA systems of one
    sparsity by BiCGStab, the counterpart of ``jax.vmap`` over
    ``bicgstab_solve``: ``cg_solve_batched``'s contract (``data`` ``(k,
    ndiags, n)``, ``B`` and ``X0`` ``(k, n)``, a ``CGResult`` with the
    leading k axis), two batched kernel #4 launches an iteration
    (``ops.cuda_dia.spmv_dia_batched_cuda``) and one host read.  The
    implicit adjoint runs it on the transposed legs of
    ``solvers.diff.dia_transpose_traced`` and the negated offsets."""
    check_batched(data, offsets, shape, B)
    offsets = tuple(int(o) for o in offsets)
    X0 = None if X0 is None else X0.to(B.dtype).expand_as(B).contiguous()
    X, it, res, converged = bicgstab_block(lambda P: spmv_dia_batched_cuda(data, offsets, P),
                                           B, X0, policy)
    return CGResult(x=X, iterations=it, residual=res, converged=converged)
