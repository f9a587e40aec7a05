"""CGNR: CG on the normal equations ``A^T A x = A^T b``.

The port of ``conjugategradient_tpu/solvers/cgnr.py``: the nonsymmetric
fallback beside BiCGStab and GMRES.  It works for any nonsingular A, with
constant memory and a monotone ``||A r||``, at the price of squaring the
condition number.

Built from existing pieces: ``core.formats.transpose`` (host setup) and the
shared ``cg_solve`` recurrence over the composed operator
``x -> A^T (A x)``.  On a CUDA ``b`` a ``DiaMatrix`` and its transpose (an
ordinary DIA with negated offsets) both run kernel #4, two launches per
iteration (per group of diagonals); the transpose of a ``StencilMatrix``
is a ``StencilMatrix`` with negated shifts (kernel #3); CSR, ELL, COO and
BSR take the port's own products (cuSPARSE for CSR).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from conjugategradient_tpu_torch.core.formats import is_host, to_host, transpose
from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def normal_operators(A, b: torch.Tensor):
    """(op, opT): the products of ``A`` and of its host transpose, both
    placed at ``b``'s dtype on ``b``'s device (a container without
    ``device_put``, a const stencil, as it is)."""
    A_host = A if is_host(A) else to_host(A)
    place = lambda M: M.device_put(b.dtype, b.device) if hasattr(M, "device_put") else M
    return as_operator(place(A_host)), as_operator(place(transpose(A_host)))


def cgnr_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    precise_dot: bool = False,
) -> CGResult:
    """Solve A x = b (square, nonsingular, possibly nonsymmetric) by CGNR
    on ``b``'s device.

    The loop's convergence test applies to the normal-equation residual
    ``||A^T (b - A x)||`` (CG's residual here); the returned ``residual``
    is the true ``||b - A x||`` in the policy's norm, re-evaluated after
    the loop.  Expect roughly the square of CG's iteration count.
    """
    op, opT = normal_operators(A, b)
    r0 = b - op(torch.zeros_like(b) if x0 is None else x0.to(b.dtype))
    rr0 = torch.dot(r0.reshape(-1), r0.reshape(-1))
    res = cg_solve(lambda x: opT(op(x)), opT(b), x0, policy, precise_dot=precise_dot)
    r = b - op(res.x)
    rr = torch.dot(r.reshape(-1), r.reshape(-1))
    return dataclasses.replace(res, residual=residual_norm(r, rr, rr0, policy.norm))
