"""Chebyshev iteration: the solver with no inner products.

The port of ``conjugategradient_tpu/solvers/cheby.py`` (Golub & Varga
1961).  Given spectral bounds ``[lo, hi]`` of an SPD A, the optimal
fixed-polynomial recurrence needs one product and three AXPYs per
iteration and no dot product; the only reduction is the convergence check,
every ``check_every`` iterations.  The bounds come from setup-time host
Lanczos (``estimate_bounds``) when not given.

A Python loop: the recurrence's coefficients are host scalars at the
solve's dtype (the JAX package computes them on the device in that dtype,
from the same values), and the host reads one device scalar per
``check_every`` iterations.  A DIA operator runs kernel #4 once per
iteration and once for the initial residual.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import to_host
from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.solvers.cg import CGResult, _setup
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def chebyshev_loop(
    op,
    b: torch.Tensor,
    x: torch.Tensor,
    policy: ConvergencePolicy,
    lo: float,
    hi: float,
    dot,
    check_every: int = 16,
    pmax_abs=None,
    n_global: Optional[int] = None,
) -> CGResult:
    """The recurrence with injected reductions (``gmres_loop``'s
    contract)."""
    dt = torch.empty(0, dtype=b.dtype).numpy().dtype.type
    n = n_global if n_global is not None else b.numel()
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    check = int(check_every)

    theta = dt((hi + lo) / 2.0)
    delta = dt((hi - lo) / 2.0)
    sigma = theta / delta
    one, two = dt(1.0), dt(2.0)

    r = b - op(x)
    rr0 = dot(r, r)
    rr = rr0

    def res_of(r, rr):
        if policy.norm == "linf" and pmax_abs is not None:
            return pmax_abs(r)
        return residual_norm(r, rr, rr0, policy.norm)

    d = torch.zeros_like(b)
    rho_prev = dt(0.0)
    it, started = 0, False
    need_rr = not (policy.norm == "linf" and pmax_abs is not None)
    while it < max_iter and (it < min_iter or bool(res_of(r, rr) >= tol)):
        for _ in range(check):
            if it >= max_iter:
                break  # the JAX package's masked steps past the cap: no-ops
            # first step: d = r / theta; later the two-term recurrence
            if started:
                rho = one / (two * sigma - rho_prev)
                d = float(rho * rho_prev) * d + float(two * rho / delta) * r
            else:
                rho = one / sigma
                d = r / float(theta)
            x = x + d
            r = r - op(d)
            rho_prev, started, it = rho, True, it + 1
        # the one reduction per `check` iterations (linf reads its max in
        # the predicate instead)
        if need_rr:
            rr = dot(r, r)
    res = res_of(r, rr)
    return CGResult(x=x, iterations=it, residual=res,
                    converged=bool(res < tol) and it >= min_iter)


def estimate_bounds(A, k: int = 40, widen: float = 0.1) -> Tuple[float, float]:
    """Setup-time spectral bounds: host Lanczos (``solvers.eigen.
    lanczos_bounds``, ``k`` steps) widened by ``widen`` on each side (an
    underestimated upper bound diverges the recurrence).  ``A`` may be a
    host or a device container (copied to the host)."""
    from conjugategradient_tpu_torch.solvers.eigen import lanczos_bounds

    A = to_host(A)
    lo_e, hi_e = lanczos_bounds(lambda v: oracle.spmv(A, v), A.shape[0], k=min(A.shape[0], k))
    return max(lo_e * (1.0 - widen), 1e-12 * hi_e), hi_e * (1.0 + widen)


def chebyshev_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    bounds: Optional[Tuple[float, float]] = None,
    check_every: int = 16,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> CGResult:
    """Solve SPD ``A x = b`` by Chebyshev iteration on ``b``'s device.

    ``bounds``: (lambda_min, lambda_max) of A, estimated by
    ``estimate_bounds`` when None (bring real bounds for production use: an
    underestimated lambda_max diverges).  ``check_every`` trades detection
    latency against reductions.  ``use_pallas`` is kept for parity and
    changes nothing.
    """
    lo, hi = estimate_bounds(A) if bounds is None else bounds
    op, dot = _setup(A, b, precise_dot, use_pallas)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    return chebyshev_loop(op, b, x, policy, float(lo), float(hi), dot, check_every=check_every)

