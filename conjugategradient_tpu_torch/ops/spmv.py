"""SpMV dispatch and operator wrapping: matrix container or callable ->
``x -> A @ x``."""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, DiaMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import spmv_dia_cuda
from conjugategradient_tpu_torch.ops.stencil import spmv_const_stencil, spmv_stencil


def spmv_dia(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k data[k, i] * x[i + offsets[k]] for a device ``DiaMatrix``
    (``A.device_put``): kernel #4 for a CUDA tensor, its twin for a CPU one."""
    return spmv_dia_cuda(A, x)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the ported formats."""
    if isinstance(A, ConstStencilMatrix):
        return spmv_const_stencil(A, x)
    if isinstance(A, StencilMatrix):
        return spmv_stencil(A, x)
    if isinstance(A, DiaMatrix):
        return spmv_dia(A, x)
    _refuse(A)


def _refuse(A):
    """Raise ``NotImplementedError`` naming the ROADMAP item that ports A's
    format."""
    raise NotImplementedError(
        f"{type(A).__name__} SpMV is not ported yet "
        "(ROADMAP queue 1: other formats and ingestion)"
    )


def as_operator(A, use_pallas: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a ``ConstStencilMatrix``, a ``StencilMatrix`` or a ``DiaMatrix``
    as its SpMV, or pass a callable through.

    ``use_pallas`` is kept for parity with the JAX package and changes
    nothing: on a CUDA tensor both values launch the hand-written kernel (the
    card is the accelerator the JAX default, ``jax.default_backend() ==
    "tpu"``, stands for), and on a CPU tensor both run the plain twin.  A
    host (numpy) ``DiaMatrix`` or ``StencilMatrix`` is placed on the CPU
    first: the solvers place one on ``b``'s device before they get here, so
    this is for a call with no right-hand side to follow.
    """
    if isinstance(A, (DiaMatrix, StencilMatrix)) and not torch.is_tensor(A.data):
        A = A.device_put(device="cpu")
    if isinstance(A, DiaMatrix):
        return partial(spmv_dia, A)
    if isinstance(A, (ConstStencilMatrix, StencilMatrix)):
        return partial(spmv, A)
    if callable(A):
        return A
    _refuse(A)
