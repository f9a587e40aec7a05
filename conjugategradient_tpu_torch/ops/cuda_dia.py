"""DIA kernels: CUDA wrappers and their plain PyTorch twins.

Three kernels of ``csrc/dia.cu`` (design notes at the top of that file):

- ``spmv_dia_cuda`` — y = A x for a flat banded ``DiaMatrix`` with any
  offsets and any number of diagonals, and ``spmv_dot_dia_cuda``, its fused
  form that also returns p·(A p) (kernel #4, replaces
  ``conjugategradient_tpu/ops/pallas_spmv.py::_cm_kernel``);
- ``spmm_dia_cuda`` — Y = A X for k right-hand sides held as ``(k, n)``,
  one coefficient stream for all k (kernel #5, replaces
  ``_cm_kernel_multi``): the library path of every multi-RHS solve;
- ``spmm_dia_acc_cuda`` — the same Y = A X in one call over groups of
  diagonals (``plan_dia_groups``), each group's x window copied into a ring
  of shared-memory buffers while an earlier group is summed, y kept in
  registers across the groups (kernel #6, replaces
  ``scripts/spmm_acc_experiment.py::kernel``; its launch is
  ``acc_geometry``).  Only the experiment module
  ``scripts/spmm_acc_experiment.py`` of this package calls it.

Instantiations, by (leg dtype, vector dtype): (fp32, fp32), (bf16, fp32)
with fp32 accumulation, and (fp64, fp64), the last for the SpMV and the
SpMM but not kernel #6.

Kernels #4 and #5 take at most ``MAX_DIAGS`` diagonals a launch; a matrix
with more runs in consecutive groups of ``A.offsets`` (``dia_groups``), one
launch each, every launch after the first adding its legs to the y the
previous one wrote, so each row takes its legs in the twin's order.  The
fused p·Ap is taken by the last group's launch.  Kernel #6 keeps the limit.

``make_kernel_operator``, ``spmv_ell_kernel`` and ``spmv_csr_kernel`` run a
CSR or ELL matrix through kernel #4 by a relayout to DIA at setup, as the
JAX package's ``make_pallas_operator`` does for its Pallas kernel.

Each wrapper runs its twin (``*_ref``) for a tensor on the CPU, and only
there.  For any other tensor it checks everything the kernels do not take
(device, dtype pair, rank and shape, contiguity, kernel #6's ``MAX_DIAGS``
limit), raises on a mismatch, and launches on the current CUDA stream; a
launch that the runtime refuses raises too.  ``launches`` on each wrapper
counts its kernel launches (every group of a chained launch) and nothing
else, and ``launches_by_dtype`` splits the count by leg dtype (``"fp32"``,
``"bf16"``, ``"fp64"``), so a run can show which instantiation it went
through; ``spmv_dia_cuda.launches_by_shape`` splits its count by (rows,
diagonals), so a run can show each level of a DIA-layout hierarchy.  The
SpMMs run k columns in chunks of 8, 4, 2 and 1 (at most 4 when chained:
``spmm_chunks``), one launch each (times the groups).
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import List, NamedTuple, Tuple

import torch

from conjugategradient_tpu_torch.core.formats import (
    CsrMatrix,
    DiaMatrix,
    EllMatrix,
    csr_to_dia,
    ell_to_csr,
    is_host,
    to_host,
)
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.ops.cuda_stencil import _CODES, TAGS, _raise_on, _stream

#: Limit of the kernels' by-value offsets struct (``csrc/dia.cu``), per
#: launch: band 160 has 159 diagonals; more run in chained groups
#: (``dia_groups``), except on kernel #6.
MAX_DIAGS = 256
#: Column chunks of one SpMM launch, largest first (template K of the kernel).
K_CHUNKS = (8, 4, 2, 1)
#: The widest column chunk of a chained SpMM (more than MAX_DIAGS
#: diagonals): its K = 8 instantiation that starts from Y spilled in fp64.
CHAINED_K = 4
#: Kernel #6's group limits (``ACC_SPAN``, ``ACC_LMAX`` in ``csrc/dia.cu``):
#: the widest offset window of a group, and its most legs (the JAX plan's
#: ``_LMAX_MULTI``).
ACC_SPAN = 512
ACC_LMAX = 48



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


@functools.lru_cache(maxsize=64)
def plan_dia_groups(offsets: Tuple[int, ...]) -> Tuple[Tuple[int, ...], ...]:
    """Kernel #6's group plan: tuples of leg indices into ``offsets``.

    Offsets are taken in ascending order; a new group starts when its
    window (largest minus smallest offset) would pass ``ACC_SPAN`` or it
    holds ``ACC_LMAX`` legs, and the group holding offset 0 moves last, as
    in the JAX package's ``plan_dia_cm``."""
    groups, cur = [], []
    for k in sorted(range(len(offsets)), key=lambda k: offsets[k]):
        if cur and (offsets[k] - offsets[cur[0]] > ACC_SPAN or len(cur) >= ACC_LMAX):
            groups.append(tuple(cur))
            cur = []
        cur.append(k)
    if cur:
        groups.append(tuple(cur))
    zero = [g for g in groups if any(offsets[k] == 0 for k in g)]
    return tuple([g for g in groups if g not in zero] + zero)


class AccGeometry(NamedTuple):
    """Kernel #6's launch for one plan: ``blocks`` of ``tile`` rows, of
    which ``interior`` have every neighbour of every row inside [0, n) (the
    untested path), and the dynamic shared memory of a block: one window of
    k columns per buffer of the ring (``stages``, or fewer for a plan of
    fewer groups), each ``tile`` plus the widest group's span entries
    wide."""

    blocks: int
    interior: int
    smem_bytes: int


def acc_geometry(offsets: Tuple[int, ...], n: int, k: int, tile: int, stages: int) -> AccGeometry:
    """The launch ``cg_spmm_dia_acc`` makes for ``offsets`` at ``n`` rows
    and k columns with ``tile`` rows per block and a ring of ``stages``
    window buffers (the library's ``cg_spmm_dia_acc_tile`` and
    ``cg_spmm_dia_acc_stages``)."""
    groups = plan_dia_groups(tuple(offsets))
    lo, hi = min(0, min(offsets)), max(0, max(offsets))
    span = max(offsets[g[-1]] - offsets[g[0]] for g in groups)
    blocks = -(-n // tile)
    first = -(-max(0, -lo) // tile)  # the first block with i0 + lo >= 0
    last = (n - hi - tile) // tile  # the last with i0 + tile + hi <= n
    smem = min(len(groups), stages) * k * (tile + span) * 4
    return AccGeometry(blocks, max(0, last - first + 1), smem)


def spmm_dia_acc_ref(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Kernel #6's schedule on whole arrays: Y = A X for ``X`` of shape
    ``(k, n)``, each group of ``plan_dia_groups`` summed into a partial in
    plan order, then the partial added into Y (which starts at zero)."""
    acc = torch.promote_types(A.data.dtype, X.dtype)
    Y = torch.zeros((X.shape[0], A.n), dtype=acc, device=X.device)
    windows = {k: (off, i0, i1) for k, off, i0, i1 in _windows(A)}
    for group in plan_dia_groups(tuple(A.offsets)):
        part = torch.zeros_like(Y)
        for k in group:
            if k in windows:
                off, i0, i1 = windows[k]
                part[:, i0:i1] += A.data[k, i0:i1].to(acc) * X[:, i0 + off : i1 + off].to(acc)
        Y += part
    return Y


def dia_groups(ndiags: int) -> List[Tuple[int, int]]:
    """The launches of kernels #4 and #5 for ``ndiags`` diagonals: legs
    ``[k0, k1)`` of ``A.offsets`` each, consecutive, at most ``MAX_DIAGS``
    a launch (one launch up to ``MAX_DIAGS``)."""
    return [(k0, min(k0 + MAX_DIAGS, ndiags)) for k0 in range(0, ndiags, MAX_DIAGS)]


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=64)
def _offsets_arg(offsets: Tuple[int, ...]):
    return (ctypes.c_int * len(offsets))(*offsets)


def _check_kernel_args(name: str, A: DiaMatrix, v: torch.Tensor, rank: int,
                       max_diags: int | None = None) -> int:
    """Raise on anything the kernels do not take (``max_diags``: a limit on
    the diagonals, for kernel #6); return the instantiation code."""
    if not isinstance(A, DiaMatrix):
        raise TypeError(f"{name}: needs a DiaMatrix, got {type(A).__name__}")
    data = A.data
    if not torch.is_tensor(data):
        raise TypeError(f"{name}: A.data must be a torch tensor (use DiaMatrix.device_put)")
    if A.ndiags < 1 or (max_diags is not None and A.ndiags > max_diags):
        top = "" if max_diags is None else f"..{max_diags}"
        raise ValueError(f"{name}: 1{top} diagonals supported, got {A.ndiags}")
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
    groups = dia_groups(A.ndiags)
    for g, (k0, k1) in enumerate(groups):
        err = lib.cg_spmv_dia(code, A.data[k0].data_ptr(), x.data_ptr(), y.data_ptr(), A.n,
                              k1 - k0, _offsets_arg(tuple(A.offsets[k0:k1])), int(g > 0),
                              _stream(x))
        _raise_on(lib, err, name)
    spmv_dia_cuda.launches += len(groups)
    spmv_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += len(groups)
    spmv_dia_cuda.launches_by_shape[(A.n, A.ndiags)] += len(groups)
    return y


spmv_dia_cuda.launches = 0
spmv_dia_cuda.launches_by_dtype = collections.Counter()
#: launches by (rows, diagonals) of the matrix: a DIA-layout hierarchy's level
spmv_dia_cuda.launches_by_shape = collections.Counter()


def spmv_dot_dia_cuda(A: DiaMatrix, p: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``(A p, p · A p)``: one matrix pass for both, the dot summed in
    a fixed order (deterministic).  The dot is a 0-d tensor on the card.
    Chained groups (more than ``MAX_DIAGS`` diagonals) run the plain SpMV
    launch but for the last group, which takes the dot."""
    if p.device.type == "cpu":
        return spmv_dot_dia_ref(A, p)
    name = "spmv_dot_dia_cuda"
    code = _check_kernel_args(name, A, p, 1)
    y = torch.empty_like(p)
    partial = torch.empty(-(-A.n // 256), dtype=p.dtype, device=p.device)
    dot = torch.empty((), dtype=p.dtype, device=p.device)
    lib = _build.load("dia")
    groups = dia_groups(A.ndiags)
    for g, (k0, k1) in enumerate(groups):
        offs = _offsets_arg(tuple(A.offsets[k0:k1]))
        if g + 1 < len(groups):
            err = lib.cg_spmv_dia(code, A.data[k0].data_ptr(), p.data_ptr(), y.data_ptr(), A.n,
                                  k1 - k0, offs, int(g > 0), _stream(p))
        else:
            err = lib.cg_spmv_dot_dia(code, A.data[k0].data_ptr(), p.data_ptr(), y.data_ptr(),
                                      partial.data_ptr(), dot.data_ptr(), A.n, k1 - k0, offs,
                                      int(g > 0), _stream(p))
        _raise_on(lib, err, name)
    spmv_dot_dia_cuda.launches += len(groups)
    spmv_dot_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += len(groups)
    return y, dot


spmv_dot_dia_cuda.launches = 0
spmv_dot_dia_cuda.launches_by_dtype = collections.Counter()


def k_chunks(k: int, widest: int = K_CHUNKS[0]):
    """The column chunks one SpMM of k columns launches, largest first, none
    wider than ``widest``."""
    out = []
    while k > 0:
        c = next(c for c in K_CHUNKS if c <= min(k, widest))
        out.append(c)
        k -= c
    return out


def spmm_dia_cuda(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for ``X`` of shape ``(k, n)``: the CUDA kernel for a CUDA
    tensor (one launch per column chunk), the twin for a CPU tensor."""
    if X.device.type == "cpu":
        return spmm_dia_ref(A, X)
    code = _check_kernel_args("spmm_dia_cuda", A, X, 2)
    launches = len(spmm_chunks(A, X.shape[0])) * len(dia_groups(A.ndiags))
    Y = _spmm_launch(_build.load("dia"), code, A, X)
    spmm_dia_cuda.launches += launches
    spmm_dia_cuda.launches_by_dtype[TAGS[A.data.dtype]] += launches
    return Y


def spmm_chunks(A: DiaMatrix, k: int):
    """The column chunks kernel #5 launches for ``A`` and k columns: up to
    8 a launch, up to ``CHAINED_K`` past ``MAX_DIAGS`` diagonals."""
    return k_chunks(k, CHAINED_K if A.ndiags > MAX_DIAGS else K_CHUNKS[0])


def _spmm_launch(lib, code: int, A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Launch kernel #5 of ``lib`` on checked arguments, one launch per
    column chunk and group of diagonals."""
    Y = torch.empty_like(X)
    groups = [(k0, k1, _offsets_arg(tuple(A.offsets[k0:k1]))) for k0, k1 in dia_groups(A.ndiags)]
    c0 = 0
    for kc in spmm_chunks(A, X.shape[0]):
        for k0, k1, offs in groups:
            err = lib.cg_spmm_dia(code, kc, A.data[k0].data_ptr(), X[c0].data_ptr(),
                                  Y[c0].data_ptr(), A.n, A.n, k1 - k0, offs, int(k0 > 0),
                                  _stream(X))
            _raise_on(lib, err, "spmm_dia_cuda")
        c0 += kc
    return Y


spmm_dia_cuda.launches = 0
spmm_dia_cuda.launches_by_dtype = collections.Counter()


@functools.lru_cache(maxsize=64)
def _plan_args(offsets: Tuple[int, ...]):
    """(ngroups, begin, off, row) of ``plan_dia_groups`` as ctypes arrays."""
    groups = plan_dia_groups(offsets)
    legs = [k for g in groups for k in g]
    begin = [0]
    for g in groups:
        begin.append(begin[-1] + len(g))
    ints = lambda v: (ctypes.c_int * len(v))(*v)
    return len(groups), ints(begin), ints([offsets[k] for k in legs]), ints(legs)


def spmm_dia_acc_cuda(A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Y = A X for ``X`` of shape ``(k, n)`` by kernel #6 (one launch per
    column chunk) for a CUDA tensor, its twin for a CPU tensor."""
    if X.device.type == "cpu":
        return spmm_dia_acc_ref(A, X)
    name = "spmm_dia_acc_cuda"
    if torch.is_tensor(getattr(A, "data", None)) and A.data.dtype == torch.float64:
        raise TypeError(f"{name}: the kernel takes fp32 or bf16 legs with fp32 columns")
    code = _check_kernel_args(name, A, X, 2, MAX_DIAGS)
    chunks = k_chunks(X.shape[0])
    Y = _acc_launch(_build.load("dia"), code, A, X)
    spmm_dia_acc_cuda.launches += len(chunks)
    spmm_dia_acc_cuda.launches_by_dtype[TAGS[A.data.dtype]] += len(chunks)
    return Y


def _acc_launch(lib, code: int, A: DiaMatrix, X: torch.Tensor) -> torch.Tensor:
    """Launch kernel #6 of ``lib`` on checked arguments, one launch per
    column chunk."""
    Y = torch.empty_like(X)
    ngroups, begin, off, row = _plan_args(tuple(A.offsets))
    c0 = 0
    for kc in k_chunks(X.shape[0]):
        err = lib.cg_spmm_dia_acc(code, kc, A.data.data_ptr(), X[c0].data_ptr(), Y[c0].data_ptr(),
                                  A.n, A.n, A.ndiags, ngroups, begin, off, row, _stream(X))
        _raise_on(lib, err, "spmm_dia_acc_cuda")
        c0 += kc
    return Y


spmm_dia_acc_cuda.launches = 0
spmm_dia_acc_cuda.launches_by_dtype = collections.Counter()


def reset_launch_counts() -> None:
    """Set every DIA kernel's launch count to 0."""
    for fn in (spmv_dia_cuda, spmv_dot_dia_cuda, spmm_dia_cuda, spmm_dia_acc_cuda):
        fn.launches = 0
        fn.launches_by_dtype.clear()
    spmv_dia_cuda.launches_by_shape.clear()


# ---------------------------------------------------------------------------
# CSR and ELL through kernel #4: a relayout to DIA at setup
# ---------------------------------------------------------------------------


def _dia_of(A) -> DiaMatrix:
    """The host DIA of a DIA, ELL or CSR matrix: every structurally present
    diagonal (``csr_to_dia``).  The counterpart of
    ``conjugategradient_tpu/ops/pallas_spmv.py::_dia_of``."""
    A = to_host(A)
    if isinstance(A, DiaMatrix):
        return A
    if isinstance(A, EllMatrix):
        return csr_to_dia(ell_to_csr(A))
    if isinstance(A, CsrMatrix):
        return csr_to_dia(A)
    raise TypeError(f"no kernel #4 relayout for {type(A)}")


def make_kernel_operator(A, device=None):
    """x -> A @ x through kernel #4 for a DIA, ELL or CSR matrix: an ELL or
    CSR one is relaid out to DIA once, here, on the host, and placed on
    ``device`` (``None``: the card when there is one), its dtype kept.  The
    counterpart of ``conjugategradient_tpu/ops/pallas_spmv.py::
    make_pallas_operator``.  A bounded band in ELL or CSR is DIA in
    disguise: one coalesced stream per diagonal, no gather.  A matrix whose
    nonzeros lie on many diagonals pays for every one of them in full (the
    relayout's storage is ``ndiags * n``)."""
    Ad = A if isinstance(A, DiaMatrix) and not is_host(A) else _dia_of(A)
    return functools.partial(spmv_dia_cuda, Ad.device_put(device=device))


def spmv_ell_kernel(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """ELL SpMV through kernel #4 (relayout to DIA on each call: keep
    ``make_kernel_operator(A)`` for repeated products).  The counterpart of
    ``conjugategradient_tpu/ops/pallas_spmv.py::spmv_ell_pallas``."""
    return make_kernel_operator(A, device=x.device)(x)


def spmv_csr_kernel(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """CSR SpMV through kernel #4 (relayout to DIA on each call: keep
    ``make_kernel_operator(A)`` for repeated products).  The counterpart of
    ``conjugategradient_tpu/ops/pallas_spmv.py::spmv_csr_pallas``."""
    return make_kernel_operator(A, device=x.device)(x)
