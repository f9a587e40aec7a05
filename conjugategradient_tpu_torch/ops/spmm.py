"""Sparse x dense: SpMM over a block of right-hand sides.

The public functions keep the JAX package's ``(n, k)`` layout.  The solver
state of ``solvers.multi`` is held as ``(k, n)`` instead (each column
contiguous, the layout kernel #5 reads) and calls
``ops.cuda_dia.spmm_dia_cuda`` directly, so the layout is converted twice
per solve, not per SpMM.
"""

from __future__ import annotations

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda


def spmm_dia(A: DiaMatrix, B: torch.Tensor) -> torch.Tensor:
    """(n, k) = A @ B for a device ``DiaMatrix``: kernel #5 for a CUDA
    tensor, its twin for a CPU one."""
    return spmm_dia_cuda(A, B.T.contiguous()).T


def spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Dispatch A @ B for a (n, k) dense block of right-hand sides."""
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k), got shape {tuple(B.shape)}")
    if isinstance(A, DiaMatrix):
        return spmm_dia(A, B)
    raise NotImplementedError(
        f"{type(A).__name__} SpMM is not ported yet "
        "(ROADMAP queue 1: other formats and ingestion)"
    )
