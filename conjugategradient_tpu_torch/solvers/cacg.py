"""s-step (communication-avoiding) CG: two reductions per s iterations.

The port of ``conjugategradient_tpu/solvers/cacg.py`` (Van Rosendale 1983;
Chronopoulos & Gear 1989; Hoemmen 2010; Carson & Demmel 2014).  Per outer
step it builds the 2s+1-row Krylov basis

    V = [p, Ap, ..., A^s p,  r, Ar, ..., A^{s-1} r]

with 2s-1 operator applications, forms the Gram matrix ``G = V V^T`` as one
``(m, n) @ (n, m)`` matmul and reads it to the host (the s-step method's
one reduction), then runs s CG steps in the m = 2s+1-dimensional
coordinate space, where A's action is the exact shift matrix B.  The
iterates are then materialised on the device at the solve's dtype (two
``(m,) @ (m, n)`` products) and the residual is replaced by the true
``b - A x`` (one more product and one dot read): the JAX package measured
that at s = 6 in fp32 the coordinate recurrence alone claims convergence
at a true relative residual of about 1e-2.  So an outer step costs 2s
products and two host reads.

The Gram is accumulated in fp64 from the basis (of the solve's dtype) and
the coordinate steps run in numpy fp64, where the JAX package, on a TPU
without fp64, keeps both at the solve's dtype.  The coordinate residual
``rc G rc`` cancels G's entries down to r.r: on the flagship (||A|| about
100, s = 4) the entries reach 1e23 against an r.r of 1e3, so fp32 leaves
nothing but rounding, and the count becomes a matter of that rounding (the
JAX package's fp32 took 9 iterations on the CPU, the same arithmetic in
numpy fp32 13, and 112 and divergence for ``jacobi_cacg``, whose scaled
basis is nearly dependent); with fp64 both take plain CG's count.  A block
also ends where the coordinate p.Ap is not positive (a Gram that lost
positivity, or overflowed), as the JAX package ends it where the
coordinate r.r is not; a block without a single step stops the solve.

In exact arithmetic the iterates equal plain CG's at every step.  The
monomial basis conditions like kappa^s: keep s <= 4 in fp32.  The
materialisation matmuls run with TF32 off (``ops.precision.no_tf32``):
TF32 operands are fatal to the iterates, as bf16 ones are on the TPU.  No
preconditioner: a general M breaks the shift identity; fold a symmetric
diagonal scaling into A instead (``api.solve(method="jacobi_cacg")``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import as_operator, prepare
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.lsmr import _sdiv
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _shift_matrix(s: int, dtype) -> np.ndarray:
    """B (numpy, ``dtype``) with A V e_j = V e_{j+1} inside each sub-basis
    (p-part columns 0..s-1 -> 1..s, r-part columns s+1..2s-1 -> s+2..2s;
    the two final columns map to 0 and are never referenced)."""
    m = 2 * s + 1
    B = np.zeros((m, m), dtype)
    for j in range(s):
        B[j + 1, j] = 1
    for j in range(s + 1, 2 * s):
        B[j + 1, j] = 1
    return B


@dataclasses.dataclass(frozen=True)
class CACGResult(CGResult):
    """A ``CGResult`` with the number of outer steps taken: one basis, one
    Gram reduction and one residual replacement each."""

    outer_steps: int = 0


def cacg_loop(
    op,
    b: torch.Tensor,
    x0: torch.Tensor,
    policy: ConvergencePolicy,
    s: int,
    dot: Callable,
    gram: Callable,
    n_global: Optional[int] = None,
    basis: Optional[Callable] = None,
) -> CACGResult:
    """The s-step recurrence with injected reductions: ``dot(u, v)`` the
    scalar product (a 0-d tensor), ``gram(V)`` the ``(m, m)`` Gram ``V V^T``
    (``gram64``: accumulated in fp64).  ``op`` and the vectors may be
    grid-shaped; the basis flattens internally.  ``basis`` optionally
    replaces the default 2s-1 ``op`` applications: ``(p, r) -> (2s+1, n)``.
    ``n_global`` is the system's row count where the vectors are row-sharded
    (``parallel.sharded_cg``: ``dot`` and ``gram`` then psum, ``basis``
    stacks each shard's rows), for ``policy.resolve_max``.  The coordinate
    scalars are host fp64 (see the module docstring)."""
    dtype, shape, dev = b.dtype, b.shape, b.device
    dt = np.dtype(np.float64)
    zero = dt.type(0)
    n = b.numel() if n_global is None else n_global
    m = 2 * s + 1
    tol = dt.type(policy.tol)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    B = _shift_matrix(s, dt)

    x = x0
    r = b - op(x)
    rr0 = dt.type(dot(r, r).item())
    if policy.norm == "rel_l2":
        tol_sq = tol * tol * rr0
    elif policy.norm == "l2":
        tol_sq = tol * tol
    else:
        raise ValueError(
            "cacg monitors ||r||_2 through the Gram matrix; linf has no "
            "coordinate-space form — use norm='l2' or 'rel_l2'"
        )

    def build_basis(p, r):
        """(m, n) rows [p, Ap, ..., A^s p, r, Ar, ..., A^{s-1} r]."""
        rows = []
        for v, k in ((p, s), (r, s - 1)):
            rows.append(v.reshape(-1))
            for _ in range(k):
                v = op(v)
                rows.append(v.reshape(-1))
        return torch.stack(rows)

    build = basis or build_basis
    e_p = np.zeros(m, dt)
    e_p[0] = 1
    e_r = np.zeros(m, dt)
    e_r[s + 1] = 1

    def active(rr, it):
        # rr > 0 guard: a zero residual (b = 0, or an exact warm start)
        # makes tol_sq = 0 under rel_l2; stop at once, as cg does
        return (it < min_iter or (rr >= tol_sq and rr > 0)) and it < max_iter

    p, rr, it, outer = r, rr0, 0, 0  # p_0 = r_0 seeds the first basis
    while active(rr, it):
        outer += 1
        V = build(p, r)
        G = gram(V).double().cpu().numpy()  # the outer step's one reduction
        # inner coordinates: x' = 0 (the s-step correction), r' = e_r (the
        # residual is basis row s+1), p' = e_p (row 0)
        xc, rc, pc = np.zeros(m, dt), e_r, e_p
        it_block = it
        for _ in range(s):
            if not active(rr, it):
                break
            w = B @ pc
            pAp = pc @ (G @ w)
            if not pAp > 0:
                # the Gram has lost positivity on the Krylov directions (a
                # rounding-dominated monomial basis in fp32, or an overflow):
                # end the block here, as the rr clamp below ends it, and let
                # the residual replacement restart from the true residual
                break
            alpha = rr / pAp
            xc = xc + alpha * pc
            rc = rc - alpha * w
            # clamp: coordinate-space rounding can push rr epsilon-negative
            rr2 = max(rc @ (G @ rc), zero)
            pc = rc + _sdiv(rr2, rr, zero) * pc
            rr, it = rr2, it + 1
        with no_tf32():
            x = x + (torch.from_numpy(xc).to(dev, dtype) @ V).reshape(shape)
            p = (torch.from_numpy(pc).to(dev, dtype) @ V).reshape(shape)
        # residual replacement at the block boundary: one product and one
        # dot read keep every convergence claim honest
        r = b - op(x)
        rr = dt.type(dot(r, r).item())
        if it == it_block:
            break  # not one coordinate step: the basis has broken down
    with np.errstate(divide="ignore", invalid="ignore"):
        res = dt.type(np.sqrt(rr / rr0) if policy.norm == "rel_l2" else np.sqrt(rr))
    converged = bool(res < tol) and it >= min_iter
    return CACGResult(x=x, iterations=it, residual=torch.tensor(res, dtype=dtype, device=dev),
                      converged=converged, outer_steps=outer)


def cacg_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    s: int = 4,
    use_pallas: bool = False,
) -> CACGResult:
    """Solve SPD ``A x = b`` by s-step CG on ``b``'s device (a host ``A``
    placed there first).  Iterate for iterate equal to ``cg_solve`` in exact
    arithmetic; the outer step that crosses the tolerance finishes its
    block, so the count can pass cg's by less than s.  ``use_pallas`` is
    kept for parity and changes nothing."""
    if int(s) < 1:
        raise ValueError("s must be >= 1")
    op = as_operator(prepare(A, b.device), use_pallas=use_pallas)
    x = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    dot = lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1))
    return cacg_loop(op, b, x, policy, int(s), dot=dot, gram=gram64)


def gram64(V: torch.Tensor) -> torch.Tensor:
    """``V V^T`` accumulated in fp64 (one matmul of the fp64 copy)."""
    V64 = V.double()
    return V64 @ V64.T
