"""Differentiable solves: implicit-function-theorem gradients through CG.

The port of ``conjugategradient_tpu/solvers/diff.py``:
``x(theta) = A(theta)^-1 b(theta)`` inside ``torch.autograd`` for inverse
problems and PDE-constrained optimisation.  Unrolling the iterations would
store every Krylov iterate; the implicit function theorem gives the exact
adjoint at the solution instead.  For ``A x = b``:

    dL/db     = lambda,        where  A^T lambda = dL/dx   (one more solve)
    dL/dA_ij  = -lambda_i x_j

so the backward pass is one adjoint solve plus the projection of
``-lambda x^T`` onto the stored diagonals, O(n) memory whatever the
iteration count.

``CgSolveImplicit`` and ``BicgstabSolveImplicit`` are ``torch.autograd.
Function``s over the tensors ``data`` and ``b`` of a DIA system, with
``offsets``, ``shape`` and ``policy`` as plain arguments;
``cg_solve_implicit`` and ``bicgstab_solve_implicit`` apply them.  The CG
form needs a symmetric A and reuses it for the adjoint; the BiCGStab form
solves with the transpose that ``dia_transpose_traced`` builds on the
device (per-diagonal rolls and masks, equal to ``formats.transpose``).  On
a CUDA ``data`` both solves run kernel #4.  The backward pass is not
itself differentiable (no double backward).

``torch.func.vmap`` cannot batch these functions: the solvers read one
scalar to the host per iteration, which a batching transform cannot trace.
Under vmap they raise; solve a batch in a Python loop instead.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

_VMAP = ("the implicit-adjoint solves cannot run under torch.func.vmap: the solvers read a "
         "scalar to the host every iteration; solve each member of the batch in a loop "
         "(ROADMAP: diff's vmap gap)")


def _project_onto_diagonals(lam: torch.Tensor, x: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """dL/d data[k, i] = -lam[i] * x[i + off_k]: the projection of
    -lam x^T onto the stored diagonals (shared by both adjoints)."""
    i = torch.arange(n, device=x.device)
    rows = []
    for off in offsets:
        valid = (i + off >= 0) & (i + off < n)
        rows.append(torch.where(valid, -lam * torch.roll(x, -off), 0.0))
    return torch.stack(rows)


def dia_transpose_traced(data: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """DIA transpose on the device: ``A[i, i+off] = data[k, i]`` becomes
    ``A^T[i, i-off] = data[k, i-off]``, per-diagonal rolls and masks
    (differentiable).  Returns the transposed data, row k holding offset
    ``-offsets[k]``: ``formats.transpose``'s data with its rows in this
    order."""
    i = torch.arange(n, device=data.device)
    rows = []
    for k, off in enumerate(offsets):
        valid = (i - off >= 0) & (i - off < n)
        rows.append(torch.where(valid, torch.roll(data[k], off), 0.0))
    return torch.stack(rows)


class CgSolveImplicit(torch.autograd.Function):
    """``x = A^-1 b`` for the symmetric DIA system ``(data, offsets,
    shape)`` by ``cg_solve``; the backward pass is one CG solve with A."""

    @staticmethod
    def forward(data, b, offsets, shape, policy):
        return cg_solve(DiaMatrix(data.contiguous(), offsets, shape), b, policy=policy).x

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, _b, offsets, shape, policy = inputs
        ctx.save_for_backward(data, output)
        ctx.offsets, ctx.shape, ctx.policy = offsets, shape, policy

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        A = DiaMatrix(data.contiguous(), ctx.offsets, ctx.shape)
        # adjoint solve: A lambda = g (A symmetric)
        lam = cg_solve(A, g.contiguous(), policy=ctx.policy).x
        return _project_onto_diagonals(lam, x, ctx.offsets, ctx.shape[0]), lam, None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(_VMAP)


class BicgstabSolveImplicit(torch.autograd.Function):
    """``x = A^-1 b`` for a nonsymmetric DIA system by ``bicgstab_solve``;
    the backward pass is one BiCGStab solve with the transpose
    (``dia_transpose_traced``)."""

    @staticmethod
    def forward(data, b, offsets, shape, policy):
        return bicgstab_solve(DiaMatrix(data.contiguous(), offsets, shape), b, policy=policy).x

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, _b, offsets, shape, policy = inputs
        ctx.save_for_backward(data, output)
        ctx.offsets, ctx.shape, ctx.policy = offsets, shape, policy

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        n = ctx.shape[0]
        AT = DiaMatrix(dia_transpose_traced(data, ctx.offsets, n).contiguous(),
                       tuple(-o for o in ctx.offsets), ctx.shape)
        lam = bicgstab_solve(AT, g.contiguous(), policy=ctx.policy).x
        return _project_onto_diagonals(lam, x, ctx.offsets, n), lam, None, None, None

    @staticmethod
    def vmap(info, in_dims, *args):
        raise NotImplementedError(_VMAP)


def cg_solve_implicit(
    data: torch.Tensor,
    b: torch.Tensor,
    offsets: Tuple[int, ...],
    shape: Tuple[int, int],
    policy: ConvergencePolicy = ConvergencePolicy(),
) -> torch.Tensor:
    """``x = A^-1 b`` for the symmetric DIA system ``(data, offsets,
    shape)``, differentiable with respect to ``data`` and ``b`` by the
    implicit adjoint (``CgSolveImplicit``).  Returns the solution only:
    call ``cg_solve`` for the iteration count and flags."""
    return CgSolveImplicit.apply(data, b, tuple(int(o) for o in offsets),
                                 tuple(int(s) for s in shape), policy)


def bicgstab_solve_implicit(
    data: torch.Tensor,
    b: torch.Tensor,
    offsets: Tuple[int, ...],
    shape: Tuple[int, int],
    policy: ConvergencePolicy = ConvergencePolicy(),
) -> torch.Tensor:
    """``x = A^-1 b`` for a nonsymmetric DIA system, differentiable with
    respect to ``data`` and ``b`` (``BicgstabSolveImplicit``: the adjoint
    solves the transposed system)."""
    return BicgstabSolveImplicit.apply(data, b, tuple(int(o) for o in offsets),
                                       tuple(int(s) for s in shape), policy)
