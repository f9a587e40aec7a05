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

Both batch under ``torch.func.vmap``, forward and backward, as the JAX
package's ``custom_vjp``s batch under ``jax.vmap``: each Function's vmap
rule (``_batched_solve``) solves the whole batch at once, ``data`` and
``b`` batched by ``cg_solve_batched`` / ``bicgstab_solve_batched`` on the
batched kernel #4, ``b`` alone by ``cg_solve_multi`` /
``bicgstab_solve_multi`` on kernel #5 (one matrix, k columns), ``data``
alone by the same batched solvers with ``b`` broadcast.  The backward
pass solves its adjoint through the same Function, so under
``torch.func.vmap(torch.func.grad(loss))`` the k adjoint solves batch too
(the solvers read a scalar to the host every iteration, which a batching
transform cannot trace, so no solve runs on a batched tensor).
``_project_onto_diagonals`` and ``dia_transpose_traced`` take a leading
batch axis.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.autograd.function import once_differentiable

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve, bicgstab_solve_batched
from conjugategradient_tpu_torch.solvers.cg import cg_solve, cg_solve_batched
from conjugategradient_tpu_torch.solvers.multi import bicgstab_solve_multi, cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

def _project_onto_diagonals(lam: torch.Tensor, x: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """dL/d data[..., k, i] = -lam[..., i] * x[..., i + off_k]: the
    projection of -lam x^T onto the stored diagonals (shared by both
    adjoints), for ``(n,)`` vectors or a ``(k, n)`` batch."""
    i = torch.arange(n, device=x.device)
    rows = []
    for off in offsets:
        valid = (i + off >= 0) & (i + off < n)
        rows.append(torch.where(valid, -lam * torch.roll(x, -off, dims=-1), 0.0))
    return torch.stack(rows, dim=-2)


def dia_transpose_traced(data: torch.Tensor, offsets, n: int) -> torch.Tensor:
    """DIA transpose on the device: ``A[i, i+off] = data[k, i]`` becomes
    ``A^T[i, i-off] = data[k, i-off]``, per-diagonal rolls and masks
    (differentiable); ``(ndiags, n)`` legs or a ``(k, ndiags, n)`` batch.
    Returns the transposed data, row k holding offset ``-offsets[k]``:
    ``formats.transpose``'s data with its rows in this order."""
    i = torch.arange(n, device=data.device)
    rows = []
    for k, off in enumerate(offsets):
        valid = (i - off >= 0) & (i - off < n)
        rows.append(torch.where(valid, torch.roll(data[..., k, :], off, dims=-1), 0.0))
    return torch.stack(rows, dim=-2)


_SINGLE = {"cg": cg_solve, "bicgstab": bicgstab_solve}
_BATCHED = {"cg": cg_solve_batched, "bicgstab": bicgstab_solve_batched}
_MULTI = {"cg": cg_solve_multi, "bicgstab": bicgstab_solve_multi}


def _solve(kind: str, data, b, offsets, shape, policy) -> torch.Tensor:
    """x = A^-1 b for one DIA system by ``kind``'s solver."""
    A = DiaMatrix(data.contiguous(), offsets, shape)
    return _SINGLE[kind](A, b.contiguous(), policy=policy).x


def _batched_solve(kind: str, info, in_dims, data, b, offsets, shape, policy):
    """The vmap rule of the implicit solves: ``(x, 0)`` with x ``(k, n)``
    for the batch dimensions ``in_dims`` of ``data`` and ``b``."""
    d_dim, b_dim = in_dims[:2]
    if d_dim is None and b_dim is None:
        return _solve(kind, data, b, offsets, shape, policy), None
    if d_dim is None:  # one matrix, k right-hand sides: kernel #5
        A = DiaMatrix(data.contiguous(), offsets, shape)
        B = b.movedim(b_dim, -1).contiguous()
        return _MULTI[kind](A, B, policy=policy).x.T, 0
    data = data.movedim(d_dim, 0).contiguous()
    B = b.movedim(b_dim, 0) if b_dim is not None else b.expand(info.batch_size, -1)
    return _BATCHED[kind](data, offsets, shape, B.contiguous(), policy=policy).x, 0


class CgSolveImplicit(torch.autograd.Function):
    """``x = A^-1 b`` for the symmetric DIA system ``(data, offsets,
    shape)`` by ``cg_solve``; the backward pass is one CG solve with A."""

    @staticmethod
    def forward(data, b, offsets, shape, policy):
        return _solve("cg", data, b, offsets, shape, policy)

    @staticmethod
    def setup_context(ctx, inputs, output):
        data, _b, offsets, shape, policy = inputs
        ctx.save_for_backward(data, output)
        ctx.offsets, ctx.shape, ctx.policy = offsets, shape, policy

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        data, x = ctx.saved_tensors
        # adjoint solve: A lambda = g (A symmetric), through the Function so
        # that it batches under vmap
        lam = CgSolveImplicit.apply(data, g, ctx.offsets, ctx.shape, ctx.policy)
        return _project_onto_diagonals(lam, x, ctx.offsets, ctx.shape[0]), lam, None, None, None

    @staticmethod
    def vmap(info, in_dims, data, b, offsets, shape, policy):
        return _batched_solve("cg", info, in_dims, data, b, offsets, shape, policy)


class BicgstabSolveImplicit(torch.autograd.Function):
    """``x = A^-1 b`` for a nonsymmetric DIA system by ``bicgstab_solve``;
    the backward pass is one BiCGStab solve with the transpose
    (``dia_transpose_traced``)."""

    @staticmethod
    def forward(data, b, offsets, shape, policy):
        return _solve("bicgstab", data, b, offsets, shape, policy)

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
        # adjoint solve: A^T lambda = g, through the Function on the
        # transposed legs so that it batches under vmap
        lam = BicgstabSolveImplicit.apply(dia_transpose_traced(data, ctx.offsets, n), g,
                                          tuple(-o for o in ctx.offsets), ctx.shape, ctx.policy)
        return _project_onto_diagonals(lam, x, ctx.offsets, n), lam, None, None, None

    @staticmethod
    def vmap(info, in_dims, data, b, offsets, shape, policy):
        return _batched_solve("bicgstab", info, in_dims, data, b, offsets, shape, policy)


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
