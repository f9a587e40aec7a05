"""MINRES for symmetric indefinite systems, on device tensors.

The port of ``conjugategradient_tpu/solvers/minres.py`` (Paige & Saunders,
SIAM J. Numer. Anal. 12, 1975): Lanczos tridiagonalisation with an
on-the-fly Givens QR of the tridiagonal, a three-term recurrence that
minimises ``||b - A x||_2`` over the Krylov space at every step.  The
canonical workload is the Helmholtz operator ``-lap(u) - k^2 u``
(``core.generators.helmholtz_system``), symmetric with eigenvalues on both
sides of zero, where CG's recurrence fails.

``M`` must be SPD (it defines the inner product of the preconditioned
Lanczos process).  The loop monitors ``phibar`` (``||r||_2`` unpreconditioned,
``||r||_M`` with ``M``); the returned residual and ``converged`` flag are
re-evaluated from the true ``b - A x`` in the policy's norm.  A Python
loop with one device-scalar read per iteration; one product per
iteration, one for the initial residual and one for the final true
residual.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.solvers.cg import CGResult, _apply_M, _safe_div, _setup
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def minres_loop(
    op,
    M: Optional[Callable],
    b: torch.Tensor,
    x: torch.Tensor,
    policy: ConvergencePolicy,
    dot: Callable,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
) -> CGResult:
    """The MINRES recurrence with injected reductions, the JAX package's
    contract: ``dot(u, v)`` the inner product, ``pmax_abs(r)`` the
    ``max|r|`` of the linf convention (default: over ``r``), ``n_global``
    the row count that sets the default ``max_iteration``."""
    n = n_global if n_global is not None else b.numel()
    dtype, dev = b.dtype, b.device
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    r1 = b - op(x)
    rr0 = dot(r1, r1)
    y = _apply_M(M, r1)
    beta1 = torch.sqrt(torch.clamp_min(dot(r1, y), 0.0))  # ||r||_M
    # the loop monitors phibar: the policy tolerance on that scale
    inner_tol = tol * beta1 if policy.norm == "rel_l2" else tol

    r2, w, w2 = r1, torch.zeros_like(b), torch.zeros_like(b)
    oldb, beta, dbar, epsln, phibar, cs, sn = one, beta1, zero, zero, beta1, -one, zero
    it = 0
    while it < max_iter:
        # unconverged and no Lanczos breakdown (beta = 0 is exact convergence)
        live = beta > 0
        if not bool(live if it < min_iter else live & (phibar >= inner_tol)):
            break
        v = _safe_div(one, beta) * y
        y2 = op(v)
        if it >= 1:
            y2 = y2 - _safe_div(beta, oldb) * r1
        alfa = dot(v, y2)
        y2 = y2 - _safe_div(alfa, beta) * r2
        r1, r2 = r2, y2
        y = _apply_M(M, r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp_min(dot(r2, y), 0.0))

        # the previous rotation on the new tridiagonal column, then the new
        # rotation eliminating beta
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp_min(torch.sqrt(gbar * gbar + beta * beta), 1e-30)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar

        w1, w2 = w2, w
        w = _safe_div(one, gamma) * (v - oldeps * w1 - delta * w2)
        x = x + phi * w
        it += 1

    # honest reporting: the true residual in the policy norm
    r = b - op(x)
    if policy.norm == "linf" and pmax_abs is not None:
        res = pmax_abs(r)
    else:
        res = residual_norm(r, dot(r, r), rr0, policy.norm)
    # a Lanczos breakdown may end the loop before min_iteration: exact
    # convergence, not failure
    converged = bool((res < tol) & ((beta == 0) | (it >= min_iter)))
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def minres_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> CGResult:
    """Solve A x = b (A symmetric, possibly indefinite) by MINRES on
    ``b``'s device.  ``M``: an optional SPD preconditioner.  ``use_pallas``
    is kept for parity and changes nothing.  Shape-agnostic (grid-shaped or
    flat ``b``)."""
    op, dot = _setup(A, b, precise_dot, use_pallas)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    return minres_loop(op, M, b, x, policy, dot=dot)
