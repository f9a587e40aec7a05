"""LSMR: iterative least squares ``min ||A x - b||_2`` for rectangular A.

The port of ``conjugategradient_tpu/solvers/lsmr.py`` (Fong & Saunders,
SIAM J. Sci. Comput. 33(5), 2011): Golub-Kahan bidiagonalization with a
double QR factorization, algebraically MINRES on the normal equations but
better behaved, with a monotonically decreasing ``||A^T r||`` that falls
out of the recurrence (``|zetabar|``).  For over- and underdetermined
systems: regression on sparse features, PDE-constrained data fitting,
deconvolution.  It solves square nonsingular systems too (a better
conditioned CGNR).

Per iteration: one product with A and one with A^T (the transpose built
once on the host, ``core.formats.transpose``), and two reductions, the
norms beta and alpha of the bidiagonalization.  The JAX package keeps the
rotation scalars on the device; here the two norms are read to the host in
one batched read per iteration, the Givens and damping rotations run in
numpy scalars at the solve's dtype (so fp32 rounds as the JAX package's
fp32 does), and the vector updates run on the device with those scalars.
On a CUDA ``b`` a ``DiaMatrix`` and its transpose run kernel #4, and a
rectangular ``CsrMatrix`` and its transpose cuSPARSE's product.

``damp`` solves ``min ||A x - b||^2 + damp^2 ||x||^2`` (ridge / Tikhonov)
by the standard damped rotations; the monitored and returned optimality
residual is then ``||A^T r - damp^2 x||``.  With ``x0`` the damping
regularizes the correction ``x - x0`` (the standard shifted form).

Convergence: ``norm="rel_l2"`` stops at ``||A^T r|| / ||A^T b|| < tol``,
``norm="l2"`` at ``||A^T r|| < tol`` (``||r||`` itself need not go to
zero); ``linf`` is refused.  The returned ``residual`` is the true
``||A^T r||`` in that sense, re-evaluated after the loop.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu_torch.solvers.cgnr import normal_operators
from conjugategradient_tpu_torch.solvers.gmres import _host_dtype
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.dot(v.reshape(-1), v.reshape(-1)))


def _sdiv(num, den, zero):
    """``_safe_div`` on numpy scalars: ``num / den``, 0 where den is 0."""
    return num / den if den != 0 else zero


def lsmr_loop(
    op,
    opT,
    b_eff: torch.Tensor,
    policy: ConvergencePolicy,
    damp: float = 0.0,
    n_iter_scale: Optional[int] = None,
    nrm=None,
):
    """The LSMR recurrence.  Its only reductions are the norms beta and
    alpha, read to the host together once per iteration.  ``nrm`` is the
    2-norm (default: over the tensor), the JAX package's hook: the
    row-sharded twin (``parallel.shard_nonsym.sharded_lsmr_loop``) passes a
    ``psum``'d norm and shard-local operators, so the two norms are its only
    collectives.

    Returns ``(x, iterations, residual, converged, normar0)``: ``x`` solves
    the (possibly damped) problem against ``b_eff``, ``residual`` is the
    true optimality residual as a 0-d tensor, ``normar0`` the host
    ``||A^T b_eff||``.
    """
    if policy.norm == "linf":
        raise ValueError("lsmr monitors ||A^T r||; use norm='l2' or 'rel_l2'")
    nrm = nrm or _norm
    dtype, dev = b_eff.dtype, b_eff.device
    dt = _host_dtype(dtype)
    zero, one_h = dt.type(0), dt.type(1)
    tol = dt.type(policy.tol)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_iter_scale or b_eff.numel())
    dampj = dt.type(damp)
    one = torch.ones((), dtype=dtype, device=dev)

    def read(*scalars):
        return torch.stack(scalars).cpu().numpy()  # one transfer for all

    # --- Golub-Kahan init ---------------------------------------------------
    beta_t = nrm(b_eff)
    u = b_eff * _safe_div(one, beta_t)
    v_un = opT(u)
    alpha_t = nrm(v_un)
    v = v_un * _safe_div(one, alpha_t)
    beta, alpha = read(beta_t, alpha_t)

    zetabar = alpha * beta  # = ||A^T r_0||
    normar0 = abs(zetabar)
    alphabar = alpha
    rho = rhobar = cbar = one_h
    sbar = zero
    h = v
    hbar = torch.zeros_like(v)
    x = torch.zeros_like(v)

    def res_of(zetabar):
        ar = abs(zetabar)
        if policy.norm == "rel_l2":
            return ar / (normar0 if normar0 != 0 else one_h)
        return ar

    it = 0
    while it < max_iter and (it < min_iter or res_of(zetabar) >= tol):
        # bidiagonalization step (raw alpha_k, not the rotated alphabar)
        u_un = op(v) - float(alpha) * u
        beta_t = nrm(u_un)
        u = u_un * _safe_div(one, beta_t)
        v_un = opT(u) - beta_t * v
        alpha_t = nrm(v_un)
        v_new = v_un * _safe_div(one, alpha_t)
        beta, alpha_new = read(beta_t, alpha_t)

        # fold the damping into the rotation: eliminate damp against
        # alphabar first; only alphahat is used below
        alphahat = np.sqrt(alphabar * alphabar + dampj * dampj)

        # rotation P_k: eliminate beta_{k+1}
        rhoold = rho
        rho = np.sqrt(alphahat * alphahat + beta * beta)
        c = _sdiv(alphahat, rho, zero)
        s = _sdiv(beta, rho, zero)
        thetanew = s * alpha_new
        alphabar = c * alpha_new

        # rotation Pbar_k: the second QR
        rhobarold = rhobar
        thetabar = sbar * rho
        rhotemp = cbar * rho
        rhobar = np.sqrt(rhotemp * rhotemp + thetanew * thetanew)
        cbar = _sdiv(rhotemp, rhobar, zero)
        sbar = _sdiv(thetanew, rhobar, zero)
        zeta = cbar * zetabar
        zetabar = -sbar * zetabar

        # solution update
        hbar = h - float(_sdiv(thetabar * rho, rhoold * rhobarold, zero)) * hbar
        x = x + float(_sdiv(zeta, rho * rhobar, zero)) * hbar
        h = v_new - float(_sdiv(thetanew, rho, zero)) * h
        v, alpha = v_new, alpha_new
        it += 1

    # the true optimality residual of the (possibly damped, possibly
    # shifted) problem the loop solved: A^T (b_eff - A x) - damp^2 x, which
    # |zetabar| tracks until the recurrence drifts
    res = nrm(opT(b_eff - op(x)) - float(dampj * dampj) * x)
    if policy.norm == "rel_l2":
        res = res / float(normar0 if normar0 != 0 else one_h)
    converged = bool(res_of(zetabar) < tol) and it >= min_iter
    return x, it, res, converged, normar0


def lsmr_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    damp: float = 0.0,
) -> CGResult:
    """Minimize ``||A x - b||`` (A of shape (m, n), any m and n) by LSMR on
    ``b``'s device.

    ``x0`` warm-starts by the standard shift (solve for ``dx`` against
    ``b - A x0``).  Returns a ``CGResult`` whose ``x`` has shape (n,) and
    whose ``residual`` and ``converged`` refer to the normal-equation
    residual ``||A^T (b - A x)||`` (see the module docstring).  The
    iteration cap defaults to ``max(m, n)``.
    """
    dtype = b.dtype
    op, opT = normal_operators(A, b)
    m, n = A.shape
    b_eff = b if x0 is None else b - op(x0.to(dtype))
    x, it, res, converged, _ = lsmr_loop(op, opT, b_eff, policy, damp=damp,
                                         n_iter_scale=max(m, n))
    if x0 is not None:
        # damp regularizes the correction dx when warm-started (the
        # standard shift); the returned x is x0 + dx
        x = x + x0.to(dtype)
    return CGResult(x=x, iterations=it, residual=res, converged=converged)
