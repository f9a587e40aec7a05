"""(Preconditioned) Conjugate Gradient on device tensors.

The recurrence lives in one place, ``_make_step``.  PyTorch has no
``lax.while_loop``, so ``cg_solve`` is a Python loop: α, β, r·z and r·r stay
0-d device tensors, and the host reads one device scalar per iteration, the
``residual >= tol`` half of the convergence predicate (the iteration bounds
are host integers).  The predicate is checked before the body, as in the JAX
package: ``min_iteration`` is inclusive and ``max_iteration`` comes from
``ConvergencePolicy.resolve_max``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.blas import dot as _dot
from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, NotConvergedError


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solve outcome.  ``converged=False`` means max_iteration was exhausted;
    ``raise_if_diverged()`` turns that into an exception."""

    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # 0-d, in the solve's dtype
    converged: bool

    def raise_if_diverged(self) -> "CGResult":
        if not self.converged:
            raise NotConvergedError(
                f"CG did not converge within {self.iterations} iterations "
                f"(residual={float(self.residual):.3e})"
            )
        return self


def _safe_div(num, den):
    """num/den with 0 when den == 0 (keeps the loop NaN-free when the initial
    guess is already exact and min_iteration forces extra sweeps)."""
    ok = den != 0
    return torch.where(ok, num, torch.zeros_like(num)) / torch.where(ok, den, torch.ones_like(den))


def _apply_M(M, r):
    """Preconditioner application: ``M`` is a callable z = M(r), or None."""
    return r if M is None else M(r)


def _cg_init(op, b, x0, M, dot, dtype):
    """Initial recurrence state (x, r, p, rz, rr) from b and the guess."""
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    r = b - op(x)
    z = _apply_M(M, r)
    p = z
    rz = dot(r, z)
    rr = dot(r, r)
    return x, r, p, rz, rr


def _make_step(op, M, dot):
    """THE CG recurrence, written once: ``step(x, r, p, rz, rr) ->
    ((x, r, p, rz, rr), (alpha, beta))``, one unconditional iteration,
    NaN-free at exact convergence via ``_safe_div``."""

    def step(x, r, p, rz, rr):
        Ap = op(p)
        alpha = _safe_div(rz, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = _apply_M(M, r)
        rz_new = dot(r, z)
        rr_new = dot(r, r)
        beta = _safe_div(rz_new, rz)
        p = z + beta * p
        return (x, r, p, rz_new, rr_new), (alpha, beta)

    return step


def cg_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> CGResult:
    """Solve A x = b by (preconditioned) CG on ``b``'s device.

    ``A`` is a ``ConstStencilMatrix``, a ``DiaMatrix`` or ``StencilMatrix``
    (a host one is placed on ``b``'s device, its dtype kept) or a callable; ``b`` may be flat or grid-shaped.
    ``use_pallas`` is kept for parity and changes nothing: a CUDA ``b``
    always runs the hand-written kernels, a CPU ``b`` their twins
    (``ops.spmv.as_operator``).  fp32 with an absolute norm can underflow
    ``r`` long before the true residual is meaningful: for plain fp32 solves
    prefer ``norm="rel_l2"``, or ``solvers.refine.refined_solve``.
    """
    if isinstance(A, (DiaMatrix, StencilMatrix)) and not torch.is_tensor(A.data):
        A = A.device_put(device=b.device)
    op = as_operator(A, use_pallas=use_pallas)
    n = b.numel()
    dtype = b.dtype
    tol = torch.tensor(policy.tol, dtype=dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)

    x, r, p, rz, rr = _cg_init(op, b, x0, M, dot, dtype)
    rr0 = rr

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    step = _make_step(op, M, dot)
    it = 0
    while it < max_iter and (it < min_iter or bool(res_of(r, rr) >= tol)):
        (x, r, p, rz, rr), _coeffs = step(x, r, p, rz, rr)
        it += 1
    res = res_of(r, rr)
    converged = bool(res < tol) and it >= min_iter
    return CGResult(x=x, iterations=it, residual=res, converged=converged)
