"""Operator wrapping: matrix container or callable -> ``x -> A @ x``."""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, DiaMatrix, StencilMatrix


def as_operator(A) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap a ``ConstStencilMatrix`` as its SpMV, or pass a callable through.
    The other storage formats are not ported yet."""
    if isinstance(A, ConstStencilMatrix):
        from conjugategradient_tpu_torch.ops.stencil import spmv_const_stencil

        return partial(spmv_const_stencil, A)
    if isinstance(A, StencilMatrix):
        raise NotImplementedError(
            "variable-coefficient stencil SpMV is not ported yet "
            "(ROADMAP queue 2 kernel #3, ops/pallas_stencil.py::_kernel_var)"
        )
    if isinstance(A, DiaMatrix):
        raise NotImplementedError(
            "DIA SpMV is not ported yet (ROADMAP queue 1 item 6a, the flagship "
            "refined solve, with queue 2 kernel #4)"
        )
    if callable(A):
        return A
    raise NotImplementedError(
        f"{type(A).__name__} SpMV is not ported yet (ROADMAP queue 1 item 8: other formats)"
    )
