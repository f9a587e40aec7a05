"""Grid-stencil SpMV and SpMM on grid-shaped tensors.

Solver state stays in its natural grid shape end to end (dots and norms
reduce over all axes).  ``spmv_const_stencil`` (const-coefficient levels,
kernel #1) and ``spmv_stencil`` (variable-coefficient levels, kernel #3) run
the CUDA kernel for a CUDA tensor and its plain twin for a CPU tensor, at
every grid size and leg dtype the kernel takes (no size threshold and no
bf16-only gate: those are TPU measurements).

The SpMMs (``spmm_const_stencil``, ``spmm_stencil``) take k right-hand sides
as ``(*grid, k)`` or flat ``(n, k)``, the JAX package's layout, and
``spmm_columns`` takes them as ``(k, n)``, the layout of ``solvers.multi``'s
state.  On a CPU tensor all three run the twin's pad-and-slice form over the
whole block, as the JAX code does; on a CUDA tensor they launch kernel #1 or
#3 once per contiguous column (a bf16-leg ``StencilMatrix`` takes kernel
#3's bf16 instantiation).  The JAX package computes the SpMM with XLA, not
Pallas, so it owes no kernel of its own.  Only ``spmm_columns`` has a caller
in the port (``solvers.multi``); the two ``(*grid, k)`` adapters are API
parity with the JAX package, held to it by the tests.
"""

from __future__ import annotations

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
    spmv_stencil_cuda,
    spmv_stencil_ref,
)


def _as_grid(x: torch.Tensor, grid):
    """Accept a flat (n,) vector where a grid-shaped tensor is the native
    layout: reshape in, and hand back the inverse reshape.  Grid-shaped input
    passes through untouched."""
    if tuple(x.shape) == tuple(grid):
        return x, (lambda y: y)
    if x.ndim == 1 and x.numel() == int(np.prod(grid)):
        return x.reshape(grid), (lambda y: y.reshape(-1))
    raise ValueError(f"array of shape {tuple(x.shape)} is not compatible with grid {grid}")


def _as_block(B: torch.Tensor, grid):
    """``_as_grid`` for a block of k columns: ``(*grid, k)`` passes through,
    a flat ``(n, k)`` block is reshaped in and out."""
    nd = len(grid)
    if B.ndim == nd + 1 and tuple(B.shape[:nd]) == tuple(grid):
        return B, (lambda y: y)
    if B.ndim == 2 and nd > 1 and B.shape[0] == int(np.prod(grid)):
        k = B.shape[1]
        return B.reshape(tuple(grid) + (k,)), (lambda y: y.reshape(-1, k))
    raise ValueError(f"array of shape {tuple(B.shape)} is not compatible with grid {grid}")


def spmv_const_stencil(A: ConstStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x with zero matrix traffic: per-leg scalar coefficients times
    shifted windows, zero outside the grid.  Flat (n,) input is reshaped in
    and out."""
    x, back = _as_grid(x, A.grid)
    return back(spmv_const_stencil_cuda(A, x))


def spmv_stencil(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a device variable-coefficient ``StencilMatrix``: its legs
    stream once, each leg upcast to the state's dtype.  Flat (n,) input is
    reshaped in and out."""
    x, back = _as_grid(x, A.grid)
    return back(spmv_stencil_cuda(A, x))


def spmm_columns(A, X: torch.Tensor) -> torch.Tensor:
    """A @ X for a ``ConstStencilMatrix`` or device ``StencilMatrix`` and k
    columns held as ``(k, n)`` or ``(k, *grid)``, each column contiguous;
    the result has ``X``'s shape."""
    k = X.shape[0]
    Xg = X.reshape((k,) + tuple(A.grid))
    const = isinstance(A, ConstStencilMatrix)
    if Xg.device.type == "cpu":
        Y = (spmv_const_stencil_ref if const else spmv_stencil_ref)(A, Xg)
    else:
        kernel = spmv_const_stencil_cuda if const else spmv_stencil_cuda
        Y = torch.stack([kernel(A, Xg[j]) for j in range(k)])
    return Y.reshape(X.shape)


def _spmm(A, B: torch.Tensor) -> torch.Tensor:
    B, back = _as_block(B, A.grid)
    Y = spmm_columns(A, torch.movedim(B, -1, 0).contiguous())
    return back(torch.movedim(Y, 0, -1))


def spmm_const_stencil(A: ConstStencilMatrix, B: torch.Tensor) -> torch.Tensor:
    """A @ B for B of shape ``(*grid, k)`` (or flat ``(n, k)``),
    constant-coefficient legs."""
    return _spmm(A, B)


def spmm_stencil(A: StencilMatrix, B: torch.Tensor) -> torch.Tensor:
    """A @ B for B of shape ``(*grid, k)`` (or flat ``(n, k)``): k
    right-hand sides of a variable-coefficient stencil."""
    return _spmm(A, B)
