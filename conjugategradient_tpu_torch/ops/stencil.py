"""Grid-stencil SpMV on grid-shaped tensors.

Solver state stays in its natural grid shape end to end (dots and norms
reduce over all axes).  ``spmv_const_stencil`` (const-coefficient levels,
kernel #1) and ``spmv_stencil`` (variable-coefficient levels, kernel #3) run
the CUDA kernel for a CUDA tensor and its plain twin for a CPU tensor, at
every grid size and leg dtype the kernel takes (no size threshold and no
bf16-only gate: those are TPU measurements).
"""

from __future__ import annotations

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_const_stencil_cuda, spmv_stencil_cuda


def _as_grid(x: torch.Tensor, grid):
    """Accept a flat (n,) vector where a grid-shaped tensor is the native
    layout: reshape in, and hand back the inverse reshape.  Grid-shaped input
    passes through untouched.  (Multi-RHS ``(*grid, k)`` blocks belong to the
    SpMM, not ported yet.)"""
    if tuple(x.shape) == tuple(grid):
        return x, (lambda y: y)
    if x.ndim == 1 and x.numel() == int(np.prod(grid)):
        return x.reshape(grid), (lambda y: y.reshape(-1))
    raise ValueError(f"array of shape {tuple(x.shape)} is not compatible with grid {grid}")


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
