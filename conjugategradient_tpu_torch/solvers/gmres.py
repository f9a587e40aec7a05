"""Restarted GMRES(m) and flexible GMRES for nonsymmetric systems, on device
tensors.

The port of ``conjugategradient_tpu/solvers/gmres.py`` (Saad & Schultz,
SIAM J. Sci. Stat. Comput. 7, 1986; FGMRES: Saad, SIAM J. Sci. Comput. 14,
1993), design for design where it is about the numbers:

- The Krylov basis is one ``(m+1, n)`` tensor.  Orthogonalisation is
  classical Gram-Schmidt done twice (CGS2): each pass a pair of dense
  products against the filled rows (``V @ w``, then ``h @ V``), which run in
  full fp32 (``ops.precision.no_tf32``: TF32 would truncate them, the
  hazard the JAX package pins with ``Precision.HIGHEST``).
- Right preconditioning with a linear ``M`` applies ``M`` once to the
  assembled correction (``x += M(V[:m]^T y)``); ``flexible=True`` keeps the
  preconditioned vectors as a second ``(m, n)`` basis Z and assembles the
  correction from it, which admits a nonlinear or iteration-varying ``M``
  (an inner Krylov solve, ``inner_solve_preconditioner``).
- Inside a cycle the loop monitors the Givens estimate ``|g[k]|``; the
  ``converged`` flag and the returned residual come from the true residual
  ``b - A x`` at cycle boundaries, in the policy's norm.

What differs is where the small work runs.  The JAX package keeps the
Hessenberg column, the Givens rotations and the ``m x m`` triangular solve
on the device inside one jitted program and runs every cycle's ``m`` steps,
masking those past convergence.  Here the host reads each new Hessenberg
column (``k + 2`` numbers, one transfer per Arnoldi step: the step's one
device read, which also decides whether the next step runs), applies the
rotations and solves the triangle in numpy at the solve's dtype, and stops
the cycle at the first frozen step, since a frozen step changes nothing.
A DIA operator runs kernel #4 once per Arnoldi step, once per cycle for
the cycle's residual, once per cycle for the true residual at its end and
once for the initial residual; ``GmresResult.cycles`` counts the cycles.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import scipy.linalg
import torch

from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.solvers.cg import CGResult, _apply_M, _safe_div, _setup
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class GmresResult(CGResult):
    """A ``CGResult`` with the restart cycles the solve ran: each cycle
    computes its residual and, at its end, the true residual (two products
    beyond its Arnoldi steps)."""

    cycles: int = 0


def _matdot_default(V: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``V @ w`` for the basis rows ``V`` in full fp32 (no TF32)."""
    with no_tf32():
        return torch.matmul(V, w)


def _host_dtype(dtype: torch.dtype):
    return torch.empty(0, dtype=dtype).numpy().dtype


def _arnoldi_column(h: np.ndarray, k: int, cs, sn, dt):
    """Apply the accumulated rotations ``0..k-1`` to the new Hessenberg
    column ``h`` (``h[k+1]`` already the new basis norm) and make rotation
    ``k``: returns (the rotated column, its ``k``-th entry R's diagonal,
    ``c_k``, ``s_k``), the JAX package's arithmetic at dtype ``dt``."""
    zero, one = dt.type(0), dt.type(1)
    for i in range(k):
        hi, hi1 = h[i], h[i + 1]
        h[i] = cs[i] * hi + sn[i] * hi1
        h[i + 1] = -sn[i] * hi + cs[i] * hi1
    hk, hk1 = h[k], h[k + 1]
    denom = np.sqrt(hk * hk + hk1 * hk1)
    ck = hk / denom if denom > 0 else one
    sk = hk1 / denom if denom != 0 else zero
    # a complete breakdown (denom == 0) parks a 1 on R's diagonal: g's
    # matching entry is 0 then, so y_k = 0
    h[k] = denom if denom > 0 else one
    return h, ck, sk


def gmres_loop(
    op,
    M_flat: Optional[Callable],
    b_flat: torch.Tensor,
    x: torch.Tensor,
    policy: ConvergencePolicy,
    m: int,
    dot: Callable,
    matdot: Callable,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
    flexible: bool = False,
) -> GmresResult:
    """The restart-cycle recurrence with injected reductions, the JAX
    package's contract: ``op`` and ``M_flat`` act on flat vectors,
    ``dot(u, v)`` is the inner product, ``matdot(V, w)`` the ``(rows, n) @
    (n,)`` basis projection, ``pmax_abs(r)`` the ``max|r|`` of the linf
    convention, ``n_global`` the row count of the default cap.
    ``flexible=True`` is FGMRES (see the module docstring).  A cycle also
    ends where the Givens estimate meets the tolerance, so the result
    counts its cycles."""
    dtype, dev = b_flat.dtype, b_flat.device
    dt = _host_dtype(dtype)
    n = n_global if n_global is not None else b_flat.numel()
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    one = torch.ones((), dtype=dtype, device=dev)

    r = b_flat - op(x)
    rr0 = dot(r, r)

    def res_of(r):
        if policy.norm == "linf" and pmax_abs is not None:
            return pmax_abs(r)
        return residual_norm(r, dot(r, r), rr0, policy.norm)

    # the cycles monitor |g[k]|, an l2 estimate: the policy tolerance on
    # that scale (l2 >= linf keeps "linf" conservative)
    tol_h = dt.type(policy.tol)
    inner_tol = tol_h * np.sqrt(dt.type(rr0.item())) if policy.norm == "rel_l2" else tol_h

    def cycle(x, it_total):
        """One GMRES(m) restart cycle from ``x``: (x, steps taken)."""
        r = b_flat - op(x)
        beta = torch.sqrt(dot(r, r))
        # r.new_zeros: a row-sharded r (parallel.mesh.Shards) gives each
        # shard its rows of the basis
        V = r.new_zeros((m + 1, r.numel()))
        V[0] = _safe_div(one, beta) * r
        Z = r.new_zeros((m, r.numel())) if flexible else None
        R = np.eye(m, dtype=dt)  # rotated Hessenberg; frozen columns keep e_j
        g = np.zeros(m + 1, dtype=dt)
        g[0] = dt.type(beta.item())
        cs, sn = np.ones(m, dtype=dt), np.zeros(m, dtype=dt)
        k = 0
        while k < m:
            it = it_total + k
            if not ((it < min_iter or abs(g[k]) >= inner_tol) and it < max_iter):
                break  # frozen from here on: the rest of the cycle is a no-op
            z = V[k] if M_flat is None else M_flat(V[k])
            if flexible:
                Z[k] = z
            w = op(z)
            Vk = V[: k + 1]
            with no_tf32():
                h1 = matdot(Vk, w)
                w = w - torch.matmul(h1, Vk)
                h2 = matdot(Vk, w)
                w = w - torch.matmul(h2, Vk)
            wnorm = torch.sqrt(dot(w, w))
            V[k + 1] = _safe_div(one, wnorm) * w
            h = np.zeros(m + 1, dtype=dt)
            h[: k + 2] = torch.cat([h1 + h2, wnorm.reshape(1)]).cpu().numpy()
            col, cs[k], sn[k] = _arnoldi_column(h, k, cs, sn, dt)
            R[: k + 1, k] = col[: k + 1]
            g[k + 1] = -sn[k] * g[k]
            g[k] = cs[k] * g[k]
            k += 1
        # frozen columns: identity diagonal and a zero right-hand side
        g_solve = np.where(np.arange(m) < k, g[:m], dt.type(0))
        y = torch.from_numpy(scipy.linalg.solve_triangular(R, g_solve, lower=False)
                             .astype(dt)).to(dev)
        with no_tf32():
            if flexible:
                return x + torch.matmul(y[:k], Z[:k]), k
            u = torch.matmul(y[:k], V[:k])
        return x + (u if M_flat is None else M_flat(u)), k

    it = cycles = 0
    res = res_of(r)
    while it < max_iter and (it < min_iter or bool(res >= tol)):
        x, k = cycle(x, it)
        it += k
        cycles += 1
        res = res_of(b_flat - op(x))
        if k == 0:
            break  # the Givens estimate already meets the scaled tolerance
    converged = bool(res < tol) and it >= min_iter
    return GmresResult(x=x, iterations=it, residual=res, converged=converged, cycles=cycles)


def gmres_loop_traced(
    op,
    M_flat: Optional[Callable],
    b_flat: torch.Tensor,
    x: torch.Tensor,
    policy: ConvergencePolicy,
    m: int,
    dot: Callable,
    matdot: Callable,
    num_cycles: int = 32,
    pmax_abs: Optional[Callable] = None,
    n_global: Optional[int] = None,
):
    """Fixed-cycle GMRES recording the true residual after every restart
    cycle (``m`` inner iterations per record), frozen after convergence.

    Each cycle runs its full ``m`` steps (an absolute inner policy at a
    tolerance of 0 in the solve's dtype, as the JAX package's 1e-300); a
    ``rel_l2`` policy is anchored to the initial residual.  The host reads
    whether the solve is done once per cycle and runs no work for a frozen
    cycle.  Returns ``(CGResult, (num_cycles,) history, (num_cycles,)
    cumulative iteration counts)``, the history in the policy's norm.
    """
    dtype, dev = b_flat.dtype, b_flat.device
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    r0 = b_flat - op(x)
    rr0 = dot(r0, r0)
    if policy.norm == "rel_l2":
        inner_norm, scale = "l2", torch.sqrt(rr0)
    else:
        inner_norm, scale = policy.norm, torch.ones((), dtype=dtype, device=dev)
    tol_inner = tol * scale
    inner = ConvergencePolicy(tol=1e-300, norm=inner_norm, max_iteration=int(m))
    if policy.norm == "linf" and pmax_abs is not None:
        res_abs = pmax_abs(r0)
    else:
        res_abs = residual_norm(r0, rr0, rr0, inner_norm)
    hist = torch.empty(num_cycles, dtype=dtype, device=dev)
    its = torch.empty(num_cycles, dtype=torch.int32, device=dev)
    it, done = 0, False
    for c in range(num_cycles):
        if not done:
            r = gmres_loop(op, M_flat, b_flat, x, inner, m, dot=dot, matdot=matdot,
                           pmax_abs=pmax_abs, n_global=n_global)
            x, it, res_abs = r.x, it + r.iterations, r.residual
            done = bool(res_abs < tol_inner) and it >= policy.min_iteration
        hist[c] = res_abs / scale
        its[c] = it
    res = res_abs / scale
    converged = bool(res < tol) and it >= policy.min_iteration
    return CGResult(x=x, iterations=it, residual=res, converged=converged), hist, its


def _flat_setup(A, b, M, precise_dot, use_pallas):
    """(op, M_flat, dot) over flat vectors for a flat or grid-shaped ``b``."""
    op0, dot = _setup(A, b, precise_dot, use_pallas)
    shape = b.shape
    if len(shape) > 1:
        op = lambda u: op0(u.reshape(shape)).reshape(-1)
        M_flat = None if M is None else (lambda u: _apply_M(M, u.reshape(shape)).reshape(-1))
    else:
        op = op0
        M_flat = None if M is None else (lambda u: _apply_M(M, u))
    return op, M_flat, dot


def _solve(A, b, x0, policy, M, restart, precise_dot, use_pallas, flexible):
    m = int(restart)
    if m < 1:
        raise ValueError("restart must be >= 1")
    op, M_flat, dot = _flat_setup(A, b, M, precise_dot, use_pallas)
    x = torch.zeros(b.numel(), dtype=b.dtype, device=b.device) if x0 is None \
        else x0.to(b.dtype).reshape(-1)
    res = gmres_loop(op, M_flat, b.reshape(-1), x, policy, m, dot=dot, matdot=_matdot_default,
                     flexible=flexible)
    return dataclasses.replace(res, x=res.x.reshape(b.shape))


def gmres_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> GmresResult:
    """Solve A x = b (A square, possibly nonsymmetric) by right-
    preconditioned GMRES(restart) on ``b``'s device.

    ``M``: a linear preconditioner (callable or ``(fn, state)`` pair).
    ``iterations`` counts Arnoldi steps across all cycles.  Grid-shaped
    ``b`` is handled (the basis is flat; ``x`` comes back in ``b``'s shape).
    ``use_pallas`` is kept for parity and changes nothing.
    """
    return _solve(A, b, x0, policy, M, restart, precise_dot, use_pallas, flexible=False)


def fgmres_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> GmresResult:
    """Solve A x = b by flexible restarted GMRES: ``gmres_solve`` with the
    preconditioned vectors kept as a second ``(restart, n)`` basis, so ``M``
    may be any callable, nonlinear or iteration-varying (an inner Krylov
    solve: ``inner_solve_preconditioner``).  With a linear ``M`` it makes
    the same iterates as ``gmres_solve``."""
    return _solve(A, b, x0, policy, M, restart, precise_dot, use_pallas, flexible=True)


def inner_solve_preconditioner(
    A,
    method: str = "bicgstab",
    iterations: int = 8,
    M: Optional[Callable] = None,
    use_pallas: bool = False,
    bounds=None,
):
    """A fixed-budget inner Krylov solve of ``A z = v`` as a preconditioner
    callable for ``fgmres_solve`` (inner-outer Krylov).

    The inner solve runs at most ``iterations`` steps of ``method``
    (``"bicgstab"``, ``"cg"`` or ``"chebyshev"``) from a zero guess at an
    unreachable tolerance: a fixed work budget, which makes the map
    nonlinear and FGMRES the required outer method.  ``M`` preconditions the
    inner solve itself (e.g. the V-cycle); ``bounds=(lo, hi)`` feeds the
    Chebyshev inner (``solvers.cheby.estimate_bounds`` when omitted).
    """
    pol = ConvergencePolicy(tol=1e-30, norm="l2", max_iteration=int(iterations))
    if method == "bicgstab":
        from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

        return lambda v: bicgstab_solve(A, v, policy=pol, M=M, use_pallas=use_pallas).x
    if method == "cg":
        from conjugategradient_tpu_torch.solvers.cg import cg_solve

        return lambda v: cg_solve(A, v, policy=pol, M=M, use_pallas=use_pallas).x
    if method == "chebyshev":
        from conjugategradient_tpu_torch.solvers.cheby import chebyshev_solve, estimate_bounds

        if M is not None:
            raise ValueError(
                "inner method 'chebyshev' takes no M (the Chebyshev iteration has no "
                "preconditioner slot: fold scaling into the operator, or use inner='cg' or "
                "'bicgstab' for a V-cycle-preconditioned inner solve)"
            )
        lo, hi = estimate_bounds(A) if bounds is None else bounds
        return lambda v: chebyshev_solve(A, v, policy=pol, bounds=(float(lo), float(hi)),
                                         check_every=int(iterations)).x
    raise ValueError(f"unknown inner method {method!r}; want bicgstab|cg|chebyshev")


def gmres_solve_traced(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    restart: int = 32,
    num_cycles: int = 32,
    precise_dot: bool = False,
):
    """Fixed-cycle GMRES recording the residual after every restart cycle
    (``gmres_loop_traced``).  Returns ``(CGResult, history, cumulative
    iterations)``, both ``(num_cycles,)`` tensors."""
    op, M_flat, dot = _flat_setup(A, b, M, precise_dot, False)
    x = torch.zeros(b.numel(), dtype=b.dtype, device=b.device) if x0 is None \
        else x0.to(b.dtype).reshape(-1)
    res, hist, its = gmres_loop_traced(op, M_flat, b.reshape(-1), x, policy, int(restart),
                                       dot=dot, matdot=_matdot_default, num_cycles=num_cycles)
    return dataclasses.replace(res, x=res.x.reshape(b.shape)), hist, its
