"""DIA kernels: CUDA wrappers and their plain PyTorch twins.

Two kernels of ``csrc/dia.cu`` (design notes at the top of that file):

- ``spmv_dia_cuda`` — y = A x for a flat banded ``DiaMatrix`` with any
  offsets, and ``spmv_dot_dia_cuda``, its fused form that also returns
  p·(A p) (kernel #4, replaces
  ``conjugategradient_tpu/ops/pallas_spmv.py::_cm_kernel``);
- ``spmm_dia_cuda`` — Y = A X for k right-hand sides held as ``(k, n)``,
  one coefficient stream for all k (kernel #5, replaces
  ``_cm_kernel_multi``).

Instantiations, by (leg dtype, vector dtype): (fp32, fp32), (bf16, fp32)
with fp32 accumulation, and, for the SpMV only, (fp64, fp64).

Each wrapper runs its twin (``*_ref``) for a tensor on the CPU, and only
there.  For any other tensor it checks everything the kernels do not take
(device, dtype pair, rank and shape, contiguity, the ``MAX_DIAGS`` limit),
raises on a mismatch, and launches on the current CUDA stream; a launch that
the runtime refuses raises too.  ``launches`` on each wrapper counts its
kernel launches and nothing else, and ``launches_by_dtype`` splits the count
by leg dtype (``"fp32"``, ``"bf16"``, ``"fp64"``), so a run can show which
instantiation it went through.  The SpMM runs k columns in chunks of
8, 4, 2 and 1, one launch each.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import Tuple

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.ops.cuda_stencil import _raise_on, _stream

#: Limit of the kernels' by-value offsets struct (``csrc/dia.cu``); band 160
#: has 159 diagonals.
MAX_DIAGS = 256
#: Column chunks of one SpMM launch, largest first (template K of the kernel).
K_CHUNKS = (8, 4, 2, 1)

#: (leg dtype, vector dtype) -> the C entry's instantiation code
_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}
#: leg dtype -> the key of ``launches_by_dtype``
TAGS = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float64: "fp64"}


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def _windows(A: DiaMatrix):
    """(k, offset, i0, i1): rows [i0, i1) of leg k whose neighbour
    i + offset lies inside [0, n)."""
    n = A.n
    for k, off in enumerate(A.offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        if i0 < i1:
            yield k, off, i0, i1


def spmv_dia_ref(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for flat ``x``: one slice pass per leg, legs added in
    ``A.offsets`` order, in the promoted dtype of the legs and ``x`` (bf16
    legs with fp32 ``x`` accumulate in fp32)."""
    acc = torch.promote_types(A.data.dtype, x.dtype)
    y = torch.zeros(A.n, dtype=acc, device=x.device)
    for k, off, i0, i1 in _windows(A):
        y[i0:i1] += A.data[k, i0:i1].to(acc) * x[i0 + off : i1 + off].to(acc)
    return y


def spmv_dot_dia_ref(A: DiaMatrix, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(A p, p · A p)``."""
    y = spmv_dia_ref(A, p)
    return y, torch.dot(p.to(y.dtype), y)


def spmm_dia_ref(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for ``X`` of shape ``(k, n)`` (each column contiguous), legs
    added in ``A.offsets`` order."""
    acc = torch.promote_types(A.data.dtype, X.dtype)
    Y = torch.zeros((X.shape[0], A.n), dtype=acc, device=X.device)
    for k, off, i0, i1 in _windows(A):
        Y[:, i0:i1] += A.data[k, i0:i1].to(acc) * X[:, i0 + off : i1 + off].to(acc)
    return Y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _offsets_arg(offsets: Tuple[int, ...]):
    return (ctypes.c_int * len(offsets))(*offsets)


def _check_kernel_args(name: str, A: DiaMatrix, v: torch.Tensor, rank: int) -> int:
    """Raise on anything the kernels do not take; return the instantiation
    code."""
    if not isinstance(A, DiaMatrix):
        raise TypeError(f"{name}: needs a DiaMatrix, got {type(A).__name__}")
    data = A.data
    if not torch.is_tensor(data):
        raise TypeError(f"{name}: A.data must be a torch tensor (use DiaMatrix.device_put)")
    if not 1 <= A.ndiags <= MAX_DIAGS:
        raise ValueError(f"{name}: 1..{MAX_DIAGS} diagonals supported, got {A.ndiags}")
    if tuple(data.shape) != (A.ndiags, A.n):
        raise ValueError(f"{name}: A.data has shape {tuple(data.shape)}, not ({A.ndiags}, {A.n})")
    if A.n >= 2**31:
        raise ValueError(f"{name}: n = {A.n} does not fit the kernels' int32 row index")
    code = _CODES.get((data.dtype, v.dtype))
    if code is None:
        raise TypeError(
            f"{name}: no kernel for {data.dtype} legs with a {v.dtype} vector; "
            f"supported: {[(str(d), str(x)) for d, x in _CODES]}"
        )
    if rank == 2 and data.dtype == torch.float64:
        raise TypeError(f"{name}: the SpMM kernel takes fp32 or bf16 legs with fp32 columns")
    if v.ndim != rank or v.shape[-1] != A.n:
        want = "(n,)" if rank == 1 else "(k, n)"
        raise ValueError(f"{name}: vector of shape {tuple(v.shape)} is not {want} with n = {A.n}")
    if not (data.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    for t in (data, v):
        if t.device.type != "cuda" or t.device != v.device:
            raise ValueError(f"{name}: the kernel needs CUDA tensors on one device, got {t.device}")
    return code


def spmv_dia_cuda(A: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for flat ``x``: the CUDA kernel for a CUDA tensor, the twin
    for a CPU tensor."""
    if x.device.type == "cpu":
        return spmv_dia_ref(A, x)
    name = "spmv_dia_cuda"
    code = _check_kernel_args(name, A, x, 1)
    y = torch.empty_like(x)
    lib = _build.load("dia")
    err = lib.cg_spmv_dia(code, A.data.data_ptr(), x.data_ptr(), y.data_ptr(), A.n, A.ndiags,
                          _offsets_arg(tuple(A.offsets)), _stream(x))
    _raise_on(lib, err, name)
    spmv_dia_cuda.launches += 1
    spmv_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += 1
    return y


spmv_dia_cuda.launches = 0
spmv_dia_cuda.launches_by_dtype = collections.Counter()


def spmv_dot_dia_cuda(A: DiaMatrix, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(A p, p · A p)``: one matrix pass for both, the dot summed in
    a fixed order (deterministic).  The dot is a 0-d tensor on the card."""
    if p.device.type == "cpu":
        return spmv_dot_dia_ref(A, p)
    name = "spmv_dot_dia_cuda"
    code = _check_kernel_args(name, A, p, 1)
    y = torch.empty_like(p)
    partial = torch.empty(-(-A.n // 256), dtype=p.dtype, device=p.device)
    dot = torch.empty((), dtype=p.dtype, device=p.device)
    lib = _build.load("dia")
    err = lib.cg_spmv_dot_dia(code, A.data.data_ptr(), p.data_ptr(), y.data_ptr(),
                              partial.data_ptr(), dot.data_ptr(), A.n, A.ndiags,
                              _offsets_arg(tuple(A.offsets)), _stream(p))
    _raise_on(lib, err, name)
    spmv_dot_dia_cuda.launches += 1
    spmv_dot_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += 1
    return y, dot


spmv_dot_dia_cuda.launches = 0
spmv_dot_dia_cuda.launches_by_dtype = collections.Counter()


def k_chunks(k: int):
    """The column chunks one SpMM of k columns launches, largest first."""
    out = []
    while k > 0:
        c = next(c for c in K_CHUNKS if c <= k)
        out.append(c)
        k -= c
    return out


def spmm_dia_cuda(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for ``X`` of shape ``(k, n)``: the CUDA kernel for a CUDA
    tensor (one launch per column chunk), the twin for a CPU tensor."""
    if X.device.type == "cpu":
        return spmm_dia_ref(A, X)
    name = "spmm_dia_cuda"
    code = _check_kernel_args(name, A, X, 2)
    Y = torch.empty_like(X)
    lib = _build.load("dia")
    offs = _offsets_arg(tuple(A.offsets))
    c0 = 0
    for kc in k_chunks(X.shape[0]):
        err = lib.cg_spmm_dia(code, kc, A.data.data_ptr(), X[c0].data_ptr(), Y[c0].data_ptr(),
                              A.n, A.n, A.ndiags, offs, _stream(X))
        _raise_on(lib, err, name)
        spmm_dia_cuda.launches += 1
        spmm_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += 1
        c0 += kc
    return Y


spmm_dia_cuda.launches = 0
spmm_dia_cuda.launches_by_dtype = collections.Counter()


def reset_launch_counts() -> None:
    """Set every DIA kernel's launch count to 0."""
    for fn in (spmv_dia_cuda, spmv_dot_dia_cuda, spmm_dia_cuda):
        fn.launches = 0
        fn.launches_by_dtype.clear()
