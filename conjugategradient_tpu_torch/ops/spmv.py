"""SpMV for every storage format, and operator wrapping: matrix container or
callable -> ``x -> A @ x``.

The counterpart of ``conjugategradient_tpu/ops/spmv.py``.  The grid and
banded formats run the hand-written kernels on a CUDA tensor and their
plain twins on a CPU one: the const stencil (kernel #1), the
variable-coefficient stencil (kernel #3) and DIA (kernel #4).  The JAX
package computes the other formats with XLA, not Pallas, so the port runs
them as plain PyTorch on either device, each row summed in a fixed order
(no atomics, so a product is the same run to run):

- CSR — ``torch.sparse_csr_tensor`` over the container's arrays (cuSPARSE
  on the card);
- COO — the same product over its row-sorted CSR (``coo_as_csr``);
- ELL — a gather of x per slot and a sum along each row;
- BSR — ``ops.spmm.spmv_bsr``: batched block products, reduced per block
  row through a CSR of blocks;
- dense — a matrix-vector product with TF32 off.

``ops.cuda_dia.make_kernel_operator`` runs a CSR or ELL matrix through
kernel #4 instead, by a relayout to DIA at setup, as the JAX package's
``make_pallas_operator`` runs them through its Pallas kernel.
"""

from __future__ import annotations

import warnings
from functools import partial
from typing import Callable

import torch

from conjugategradient_tpu_torch.core.formats import (
    BsrMatrix,
    ConstStencilMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    StencilMatrix,
    is_host,
)
from conjugategradient_tpu_torch.ops.cuda_dia import spmv_dia_cuda
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.stencil import spmv_const_stencil, spmv_stencil


def spmv_dia(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y[i] = sum_k data[k, i] * x[i + offsets[k]] for a device ``DiaMatrix``
    (``A.device_put``): kernel #4 for a CUDA tensor, its twin for a CPU one."""
    return spmv_dia_cuda(A, x)


def csr_tensor(A: CsrMatrix, dtype=None) -> torch.Tensor:
    """A device ``CsrMatrix`` as a ``torch.sparse_csr_tensor`` over the same
    index arrays, its values cast to ``dtype`` (``None``: kept)."""
    data = A.data if dtype is None else A.data.to(dtype)
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sparse (CSR tensor support|invariant checks)")
        return torch.sparse_csr_tensor(A.indptr, A.indices, data, size=A.shape,
                                       check_invariants=False)


def coo_as_csr(A: CooMatrix) -> CsrMatrix:
    """A device ``CooMatrix`` as a CSR on its device: entries stably sorted
    by row (duplicates kept, to be summed by the product), so each row sums
    in a fixed order."""
    order = torch.argsort(A.rows, stable=True)
    rows = A.rows[order]
    indptr = torch.zeros(A.n + 1, dtype=torch.int32, device=rows.device)
    indptr[1:] = torch.cumsum(torch.bincount(rows, minlength=A.n), 0)
    return CsrMatrix(A.data[order].contiguous(), A.cols[order].contiguous(), indptr,
                     rows.contiguous(), A.shape)


def prepare(A, device):
    """The container that a loop of products of ``A`` runs on, made once
    before the loop: a host container placed on ``device`` (its dtype
    kept), a COO matrix as its row-sorted CSR (``coo_as_csr``), anything
    else as it is.  ``as_operator`` and the multi-RHS operator of
    ``solvers.multi`` both start here."""
    if is_host(A):
        A = A.device_put(device=device)
    if isinstance(A, CooMatrix):
        A = coo_as_csr(A)
    return A


def _acc(A, x):
    return torch.promote_types(A.data.dtype, x.dtype)


def spmv_csr(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a device ``CsrMatrix``, in the promoted dtype of its data
    and ``x``."""
    acc = _acc(A, x)
    return csr_tensor(A, acc) @ x.to(acc)


def spmv_coo(A: CooMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a device ``CooMatrix``, duplicates summed."""
    return spmv_csr(coo_as_csr(A), x)


def spmv_ell(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Gather-based ELL SpMV; padding slots hold 0, so no masking."""
    acc = _acc(A, x)
    return (A.data.to(acc) * x.to(acc)[A.cols]).sum(dim=1)


def spmv_dense(A: DenseMatrix, x: torch.Tensor) -> torch.Tensor:
    """Dense matrix-vector product, TF32 off."""
    acc = _acc(A, x)
    with no_tf32():
        return A.data.to(acc) @ x.to(acc)


def spmv(A, x: torch.Tensor) -> torch.Tensor:
    """y = A x for any container; a host one is placed on ``x``'s device
    first (a copy per call: place it once with ``device_put`` in a loop)."""
    if is_host(A):
        A = A.device_put(device=x.device)
    if isinstance(A, ConstStencilMatrix):
        return spmv_const_stencil(A, x)
    if isinstance(A, StencilMatrix):
        return spmv_stencil(A, x)
    if isinstance(A, DiaMatrix):
        return spmv_dia(A, x)
    if isinstance(A, EllMatrix):
        return spmv_ell(A, x)
    if isinstance(A, CsrMatrix):
        return spmv_csr(A, x)
    if isinstance(A, CooMatrix):
        return spmv_coo(A, x)
    if isinstance(A, BsrMatrix):
        from conjugategradient_tpu_torch.ops.spmm import spmv_bsr

        return spmv_bsr(A, x)
    if isinstance(A, DenseMatrix):
        return spmv_dense(A, x)
    raise TypeError(f"unsupported matrix type {type(A)}")


def as_operator(A, use_pallas: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    """Wrap any container as its SpMV, or pass a callable through; anything
    else raises ``TypeError``.

    ``use_pallas`` is kept for parity with the JAX package and changes
    nothing: on a CUDA tensor the grid and DIA formats launch their kernels
    (the card is the accelerator the JAX default, ``jax.default_backend() ==
    "tpu"``, stands for), and on a CPU tensor they run the plain twins.  A
    host (numpy) container is placed on the CPU first: the solvers place one
    on ``b``'s device before they get here, so this is for a call with no
    right-hand side to follow.  A COO matrix is sorted into its CSR once,
    here (``prepare``).
    """
    A = prepare(A, "cpu")
    if isinstance(A, DiaMatrix):
        return partial(spmv_dia, A)
    if isinstance(A, (ConstStencilMatrix, StencilMatrix, EllMatrix, CsrMatrix, BsrMatrix,
                      DenseMatrix)):
        return partial(spmv, A)
    if callable(A):
        return A
    raise TypeError(f"unsupported matrix type {type(A)}")
