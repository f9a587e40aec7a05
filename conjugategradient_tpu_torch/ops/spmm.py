"""Sparse x dense: BSR SpMV and SpMM over a block of right-hand sides for
every format.

The counterpart of ``conjugategradient_tpu/ops/spmm.py``.  The public
functions keep the JAX package's ``(n, k)`` layout.  The solver state of
``solvers.multi`` is held as ``(k, n)`` instead (each column contiguous, the
layout kernel #5 reads) and calls ``ops.cuda_dia.spmm_dia_cuda`` directly
for DIA, so the layout is converted twice per solve, not per SpMM.  The
other formats are plain PyTorch on either device, as ``ops.spmv`` describes:
each row sums in a fixed order, dense and block products with TF32 off.
"""

from __future__ import annotations

import torch

from conjugategradient_tpu_torch.core.formats import (
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    is_host,
)
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import _acc, coo_as_csr, csr_tensor, spmv_ell


def _block_rows(A: BsrMatrix, prods: torch.Tensor) -> torch.Tensor:
    """Sum ``prods`` (nblocks, w) over each block row, through the CSR of
    blocks (block row -> its blocks, weight 1): the fixed-order row sum of a
    sparse product in place of the JAX package's ``segment_sum``."""
    nbr = A.shape[0] // A.block_shape[0]
    ones = torch.ones(A.nblocks, dtype=prods.dtype, device=prods.device)
    cols = torch.arange(A.nblocks, dtype=A.indptr.dtype, device=prods.device)
    blocks = CsrMatrix(ones, cols, A.indptr, A.block_row_ids, (nbr, A.nblocks))
    return csr_tensor(blocks) @ prods


def spmv_bsr(A: BsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Block-CSR SpMV: the C-wide slices of x each stored block needs, one
    batched (R, C) x (C,) product, then a sum per block row."""
    R, C = A.block_shape
    acc = _acc(A, x)
    gathered = x.to(acc).reshape(-1, C)[A.indices]  # (nblocks, C)
    with no_tf32():
        prods = torch.bmm(A.data.to(acc), gathered[:, :, None])[:, :, 0]  # (nblocks, R)
    return _block_rows(A, prods).reshape(-1)


def spmm_dia(A: DiaMatrix, B: torch.Tensor) -> torch.Tensor:
    """(n, k) = A @ B for a device ``DiaMatrix``: kernel #5 for a CUDA
    tensor, its twin for a CPU one."""
    return spmm_dia_cuda(A, B.T.contiguous()).T


def spmm_csr(A: CsrMatrix, B: torch.Tensor) -> torch.Tensor:
    acc = _acc(A, B)
    return csr_tensor(A, acc) @ B.to(acc)


def spmm_ell(A: EllMatrix, B: torch.Tensor) -> torch.Tensor:
    """Column by column, each ``spmv_ell``'s gather and row sum: each column
    is that SpMV's numbers, and no (n, slots, k) gather is held at once."""
    Bt = B.T.contiguous()
    return torch.stack([spmv_ell(A, Bt[j]) for j in range(Bt.shape[0])], dim=1)


def spmm_coo(A: CooMatrix, B: torch.Tensor) -> torch.Tensor:
    return spmm_csr(coo_as_csr(A), B)


def spmm_bsr(A: BsrMatrix, B: torch.Tensor) -> torch.Tensor:
    """Batched (R, C) x (C, k) block products, then a sum per block row."""
    R, C = A.block_shape
    k = B.shape[1]
    acc = _acc(A, B)
    gathered = B.to(acc).reshape(-1, C, k)[A.indices]  # (nblocks, C, k)
    with no_tf32():
        prods = torch.bmm(A.data.to(acc), gathered)  # (nblocks, R, k)
    return _block_rows(A, prods.reshape(A.nblocks, R * k)).reshape(A.shape[0], k)


def spmm_dense(A: DenseMatrix, B: torch.Tensor) -> torch.Tensor:
    acc = _acc(A, B)
    with no_tf32():
        return A.data.to(acc) @ B.to(acc)


def spmm(A, B: torch.Tensor) -> torch.Tensor:
    """Dispatch A @ B for a (n, k) dense block of right-hand sides; a host
    container is placed on ``B``'s device first.  A grid stencil raises
    ``TypeError`` as the JAX dispatch does (``solvers.multi`` runs stencils
    by ``ops.stencil.spmm_columns``)."""
    if B.ndim != 2:
        raise ValueError(f"B must be (n, k), got shape {tuple(B.shape)}")
    if is_host(A):
        A = A.device_put(device=B.device)
    if isinstance(A, DiaMatrix):
        return spmm_dia(A, B)
    if isinstance(A, CsrMatrix):
        return spmm_csr(A, B)
    if isinstance(A, EllMatrix):
        return spmm_ell(A, B)
    if isinstance(A, CooMatrix):
        return spmm_coo(A, B)
    if isinstance(A, BsrMatrix):
        return spmm_bsr(A, B)
    if isinstance(A, DenseMatrix):
        return spmm_dense(A, B)
    raise TypeError(f"unsupported matrix type {type(A)}")
