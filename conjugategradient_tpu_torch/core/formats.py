"""Host-side (numpy) sparse containers for the PyTorch port.

The counterparts of ``conjugategradient_tpu/core/formats.py``: ``DiaMatrix``,
``StencilMatrix`` and ``ConstStencilMatrix`` (the grid and banded fast
paths), and ``EllMatrix`` (diagonal-first ELL, the reference's HandmadeCL
storage), ``CsrMatrix`` (cuSPARSE's, with ``row_ids``), ``CooMatrix``,
``BsrMatrix`` (with ``block_row_ids``) and ``DenseMatrix``, plus the
conversions between them.  They are plain frozen dataclasses over numpy
arrays: setup stays on the host.  ``device_put(dtype=None, device=None)``
gives the device-resident operator (its arrays torch tensors, index arrays
int32, as the JAX package's hold ``jnp`` arrays), on the card by default
(``default_device``); ``ConstStencilMatrix`` has no array data at all (its
coefficients, shifts and grid are static Python values that the CUDA
kernels take by value).  ``to_sparse_coo`` and ``from_sparse_coo`` hand a
matrix to and from PyTorch's own sparse tensors, as the JAX package's
``to_bcoo`` and ``from_bcoo`` do with JAX's.

The code is a numpy-only copy of the JAX package's host helpers (that package
imports ``jax`` at its root, which the GPU machine does not have); the
differential tests hold the two to the same results, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Shape = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class DiaMatrix:
    """Diagonal (banded) storage.

    ``data[k, i] == A[i, i + offsets[k]]`` and is exactly zero whenever
    ``i + offsets[k]`` falls outside ``[0, n)``.
    """

    data: np.ndarray  # (ndiags, n)
    offsets: Tuple[int, ...]
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def ndiags(self) -> int:
        return len(self.offsets)

    @property
    def bandwidth(self) -> int:
        """Largest |offset|."""
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def nnz(self) -> int:
        """Stored entries that can be structurally nonzero (diagonal lengths)."""
        return int(sum(self.n - abs(o) for o in self.offsets))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DiaMatrix":
        return DiaMatrix(self.data.astype(dtype), self.offsets, self.shape)

    def device_put(self, dtype=None, device=None) -> "DiaMatrix":
        """A ``DiaMatrix`` whose ``data`` is a contiguous torch tensor on
        ``device`` (``None``: the card when there is one, see
        ``default_device``), cast to ``dtype`` (a numpy or torch dtype, e.g.
        ``torch.bfloat16`` for a half-width matrix stream).  Same dtype on
        the CPU shares memory with the numpy array."""
        return DiaMatrix(_put(self.data, dtype, device), self.offsets, self.shape)


def default_device(device=None):
    """``device`` as a ``torch.device``; ``None`` takes the card when there
    is one, as the JAX package places on its default backend.  Every entry
    point of the port that takes ``device`` resolves it here."""
    import torch

    if device is not None:
        return torch.device(device)
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def _put(data, dtype, device):
    """Host numpy (or torch) ``data`` as a contiguous tensor on ``device``
    in ``dtype`` (``None``: keep it)."""
    import torch

    t = data if torch.is_tensor(data) else torch.from_numpy(np.asarray(data))
    dt = t.dtype if dtype is None else torch_dtype(dtype)
    return t.to(device=default_device(device), dtype=dt).contiguous()


def place(a, dtype, device):
    """A host array (or a torch tensor on any device) as a tensor on
    ``device``, cast to ``dtype`` (``None``: keep its dtype).  A tensor
    moves device to device, with no host round trip."""
    import torch

    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(np.asarray(a)))
    return t.to(device=device, dtype=t.dtype if dtype is None else torch_dtype(dtype))


def host_f64(a) -> np.ndarray:
    """A host array (or a torch tensor on any device) as a host fp64 numpy
    array: one copy to the host for a device tensor, none for a host fp64
    array or CPU fp64 tensor (the result then shares its memory)."""
    import torch

    if torch.is_tensor(a):
        a = a.detach().to(device="cpu", dtype=torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def torch_dtype(dtype):
    """The torch dtype of a torch or numpy dtype (or scalar type)."""
    import torch

    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _stencil_nnz(shifts, grid) -> int:
    total = 0
    for s in shifts:
        inside = 1
        for g, d in zip(grid, s):
            inside *= max(g - abs(d), 0)
        total += inside
    return total


@dataclasses.dataclass(frozen=True)
class StencilMatrix:
    """Variable-coefficient stencil on a d-dimensional tensor grid.

    ``data[k][idx] = A[idx, idx + shifts[k]]`` in grid coordinates; legs hold
    exact zeros where the neighbour exits the grid.  Host setup holds numpy
    legs; ``device_put`` gives the device operator (torch legs), which the
    variable-coefficient SpMV (``ops.stencil.spmv_stencil``, kernel #3 on
    the card) streams once per product.
    """

    data: np.ndarray  # (nlegs, *grid): numpy on the host, torch on a device
    shifts: Tuple[Tuple[int, ...], ...]
    grid: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def n(self) -> int:
        return int(np.prod(self.grid))

    @property
    def shape(self) -> Shape:
        return (self.n, self.n)

    @property
    def nlegs(self) -> int:
        return len(self.shifts)

    @property
    def nnz(self) -> int:
        return _stencil_nnz(self.shifts, self.grid)

    @property
    def halo(self) -> Tuple[int, ...]:
        return tuple(max(abs(s[ax]) for s in self.shifts) for ax in range(self.ndim))

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "StencilMatrix":
        """The same stencil with its legs cast to ``dtype``: numpy legs take
        a numpy dtype, torch legs a torch or numpy one (e.g.
        ``torch.bfloat16`` legs under fp32 state)."""
        import torch

        if torch.is_tensor(self.data):
            return StencilMatrix(self.data.to(torch_dtype(dtype)).contiguous(), self.shifts, self.grid)
        return StencilMatrix(np.asarray(self.data).astype(dtype), self.shifts, self.grid)

    def device_put(self, dtype=None, device=None) -> "StencilMatrix":
        """A ``StencilMatrix`` whose legs are a contiguous torch tensor on
        ``device``, cast to ``dtype`` (a numpy or torch dtype), as
        ``DiaMatrix.device_put``.  Same dtype on the CPU shares memory with
        the numpy array."""
        return StencilMatrix(_put(self.data, dtype, device), self.shifts, self.grid)


@dataclasses.dataclass(frozen=True)
class ConstStencilMatrix:
    """Constant-coefficient stencil: one scalar per leg, no grid-shaped data.

    A neighbour outside the grid contributes 0 (Dirichlet), which is exactly
    the matrix's missing entry, so the operator streams zero matrix bytes.
    ``coeffs``, ``shifts`` and ``grid`` are static: the SpMV kernel receives
    them by value at launch.
    """

    coeffs: Tuple[float, ...]
    shifts: Tuple[Tuple[int, ...], ...]
    grid: Tuple[int, ...]

    @property
    def ndim(self) -> int:
        return len(self.grid)

    @property
    def n(self) -> int:
        return int(np.prod(self.grid))

    @property
    def shape(self) -> Shape:
        return (self.n, self.n)

    @property
    def nlegs(self) -> int:
        return len(self.shifts)

    @property
    def nnz(self) -> int:
        return _stencil_nnz(self.shifts, self.grid)

    @property
    def halo(self) -> Tuple[int, ...]:
        return tuple(max(abs(s[ax]) for s in self.shifts) for ax in range(self.ndim))


def stencil_to_const(st: StencilMatrix):
    """StencilMatrix -> ConstStencilMatrix when exactly representable (each
    leg constant over its in-grid region, zero outside), else None."""
    data = np.asarray(st.data)
    nd = st.ndim
    coeffs = []
    for k, s in enumerate(st.shifts):
        # the valid region is a hyperrectangle; clamp the stop at the start so
        # a |shift| >= extent leg has an empty region instead of wrapping
        ins = tuple(
            slice(max(0, -d), max(max(0, -d), st.grid[ax] - max(0, d)))
            for ax, d in enumerate(s)
        )
        leg = data[k]
        inside = leg[ins]
        if inside.size == 0:
            coeffs.append(0.0)
            continue
        c = inside.flat[0]
        if not np.all(inside == c):
            return None
        # outside = union of per-axis border slabs; check each
        for ax, d in enumerate(s):
            if d == 0:
                continue
            sl = [slice(None)] * nd
            sl[ax] = slice(st.grid[ax] - d, None) if d > 0 else slice(0, -d)
            if np.any(leg[tuple(sl)] != 0):
                return None
        coeffs.append(float(c))
    return ConstStencilMatrix(tuple(coeffs), st.shifts, st.grid)


def dia_to_dense(dia: DiaMatrix) -> "DenseMatrix":
    """The dense ``(n, n)`` matrix of a DIA matrix (the coarsest-level
    inverse)."""
    n = dia.n
    data = np.asarray(dia.data)
    out = np.zeros((n, n), dtype=data.dtype)
    for k, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        out[i, i + off] = data[k, i]
    return DenseMatrix(out)


def _grid_strides(grid: Tuple[int, ...]) -> Tuple[int, ...]:
    """Row-major strides: flat = sum(idx[ax] * strides[ax])."""
    s = [1] * len(grid)
    for ax in range(len(grid) - 2, -1, -1):
        s[ax] = s[ax + 1] * grid[ax + 1]
    return tuple(s)


def _decompose_offset(off: int, grid: Tuple[int, ...]) -> Tuple[int, ...]:
    """Flat row-major offset -> canonical per-axis shift with |shift| < grid
    extent, each component nearest zero; raises when no in-extent
    decomposition exists."""
    strides = _grid_strides(grid)
    rem = off
    out = []
    for ax in range(len(grid)):
        st = strides[ax]
        max_rest = sum((grid[a] - 1) * strides[a] for a in range(ax + 1, len(grid)))
        # feasible components: |d| < extent and the remainder representable by
        # the remaining axes; take the element nearest rem/st
        lo = max(-(grid[ax] - 1), -((max_rest - rem) // st))
        hi = min(grid[ax] - 1, (rem + max_rest) // st)
        if lo > hi:
            raise ValueError(f"offset {off} not decomposable on grid {grid}")
        d = int(np.clip(int(np.round(rem / st)), lo, hi))
        rem = rem - d * st
        out.append(d)
    if rem != 0:
        raise ValueError(f"offset {off} not decomposable on grid {grid}")
    return tuple(out)


def dia_to_stencil(dia: DiaMatrix, grid: Tuple[int, ...], copy: bool = True) -> StencilMatrix:
    """DIA -> grid stencil.  Every flat offset must decompose into a per-axis
    shift, and entries that wrap a grid seam must already be zero; violations
    raise.  ``copy=False`` returns the legs as a reshape view of ``dia.data``
    (mutating either then changes the other)."""
    n = int(np.prod(grid))
    if dia.n != n:
        raise ValueError(f"prod(grid)={n} != n={dia.n}")
    data = np.asarray(dia.data)
    nd = len(grid)
    shifts = []
    view = data.reshape((dia.ndiags,) + tuple(grid))
    if copy:
        view = view.copy()
    for k, off in enumerate(dia.offsets):
        shift = _decompose_offset(off, grid)
        shifts.append(shift)
        for ax, s_ in enumerate(shift):
            if s_ == 0:
                continue
            # the invalid set of a leg is a union of per-axis border slabs
            sl = [slice(None)] * nd
            sl[ax] = slice(grid[ax] - s_, None) if s_ > 0 else slice(0, -s_)
            strip = view[k][tuple(sl)]
            if np.any(strip != 0):
                raise ValueError(
                    f"offset {off}: {int(np.count_nonzero(strip))} nonzeros "
                    "wrap a grid seam; matrix is not a stencil on this grid"
                )
    return StencilMatrix(view, tuple(shifts), tuple(grid))


def dia_diagonal(dia: DiaMatrix) -> np.ndarray:
    """The main diagonal (for Jacobi scaling and smoothers)."""
    if 0 not in dia.offsets:
        return np.zeros(dia.n, dtype=np.asarray(dia.data).dtype)
    return np.asarray(dia.data)[dia.offsets.index(0)].copy()


def _is_tensor(a) -> bool:
    import torch

    return torch.is_tensor(a)


def _cast(a, dtype):
    """``a`` (numpy or torch) cast to ``dtype``."""
    if _is_tensor(a):
        return a.to(torch_dtype(dtype))
    return np.asarray(a).astype(dtype)


@dataclasses.dataclass(frozen=True)
class EllMatrix:
    """ELLPACK storage: fixed width ``k`` per row, padded.

    The reference's ELL with per-row nonzero counts
    (``Mgcg/HandmadeCL/MgcgCL/SparseMatrix.cs:23,71-88``).  Padding slots
    point at the row's own index (modulo the column count) and hold 0, so a
    gather-based SpMV needs no masking.  ``csr_to_ell`` stores the diagonal
    entry first and raises when a row passes ``k`` (the reference's overflow
    rule, ``SparseMatrix.cs:138-141``).
    """

    data: np.ndarray  # (n, k)
    cols: np.ndarray  # (n, k) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def k(self) -> int:
        return int(self.data.shape[1])

    @property
    def nnz(self) -> int:
        """Stored slots, padding included."""
        return int(self.data.shape[0]) * self.k

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "EllMatrix":
        return EllMatrix(_cast(self.data, dtype), self.cols, self.shape)

    def device_put(self, dtype=None, device=None) -> "EllMatrix":
        """An ``EllMatrix`` of contiguous tensors on ``device`` (``None``: the
        card when there is one), ``data`` cast to ``dtype``, ``cols`` int32."""
        return EllMatrix(_put(self.data, dtype, device), _put(self.cols, np.int32, device),
                         self.shape)


@dataclasses.dataclass(frozen=True)
class CsrMatrix:
    """Compressed sparse row, as in ``Mgcg/cuBlas/Mgcg/SparseMatrix.cs:13-23``.

    ``row_ids`` (the row of every stored entry) is precomputed, as in the
    JAX package, so a product can reduce by row without walking ``indptr``.
    """

    data: np.ndarray  # (nnz,)
    indices: np.ndarray  # (nnz,) int32 column indices
    indptr: np.ndarray  # (n+1,) int32
    row_ids: np.ndarray  # (nnz,) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CsrMatrix":
        return CsrMatrix(_cast(self.data, dtype), self.indices, self.indptr, self.row_ids, self.shape)

    def device_put(self, dtype=None, device=None) -> "CsrMatrix":
        """A ``CsrMatrix`` of contiguous tensors on ``device``, ``data`` cast
        to ``dtype``, the index arrays int32."""
        return CsrMatrix(_put(self.data, dtype, device), _put(self.indices, np.int32, device),
                         _put(self.indptr, np.int32, device), _put(self.row_ids, np.int32, device),
                         self.shape)


@dataclasses.dataclass(frozen=True)
class CooMatrix:
    """Coordinate triplets (build and interchange format)."""

    data: np.ndarray  # (nnz,)
    rows: np.ndarray  # (nnz,) int32
    cols: np.ndarray  # (nnz,) int32
    shape: Shape

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nnz(self) -> int:
        return int(self.data.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "CooMatrix":
        return CooMatrix(_cast(self.data, dtype), self.rows, self.cols, self.shape)

    def device_put(self, dtype=None, device=None) -> "CooMatrix":
        """A ``CooMatrix`` of contiguous tensors on ``device``, ``data`` cast
        to ``dtype``, the index arrays int32."""
        return CooMatrix(_put(self.data, dtype, device), _put(self.rows, np.int32, device),
                         _put(self.cols, np.int32, device), self.shape)


@dataclasses.dataclass(frozen=True)
class BsrMatrix:
    """Block CSR: dense (R, C) blocks in CSR layout over the block grid.

    ``block_row_ids`` is precomputed, as CSR's ``row_ids``.  ``shape`` is
    the element shape and divides by the block shape.
    """

    data: np.ndarray  # (nblocks, R, C)
    indices: np.ndarray  # (nblocks,) int32 block-column ids
    indptr: np.ndarray  # (n_block_rows + 1,) int32
    block_row_ids: np.ndarray  # (nblocks,) int32
    shape: Shape

    @property
    def block_shape(self) -> Shape:
        return (int(self.data.shape[1]), int(self.data.shape[2]))

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def nblocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def nnz(self) -> int:
        """Stored entries, explicit zeros of the blocks included."""
        r, c = self.block_shape
        return self.nblocks * r * c

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "BsrMatrix":
        return BsrMatrix(_cast(self.data, dtype), self.indices, self.indptr, self.block_row_ids,
                         self.shape)

    def device_put(self, dtype=None, device=None) -> "BsrMatrix":
        """A ``BsrMatrix`` of contiguous tensors on ``device``, ``data`` cast
        to ``dtype``, the index arrays int32."""
        return BsrMatrix(_put(self.data, dtype, device), _put(self.indices, np.int32, device),
                         _put(self.indptr, np.int32, device),
                         _put(self.block_row_ids, np.int32, device),
                         self.shape)


@dataclasses.dataclass(frozen=True)
class DenseMatrix:
    """Dense matrix (the reference's R prototype path, ``R/CG.R:4-24``)."""

    data: np.ndarray  # (n, m)

    @property
    def shape(self) -> Shape:
        return (int(self.data.shape[0]), int(self.data.shape[1]))

    @property
    def n(self) -> int:
        return self.shape[0]

    @property
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DenseMatrix":
        return DenseMatrix(_cast(self.data, dtype))

    def device_put(self, dtype=None, device=None) -> "DenseMatrix":
        """A ``DenseMatrix`` whose ``data`` is a contiguous tensor on
        ``device``, cast to ``dtype``."""
        return DenseMatrix(_put(self.data, dtype, device))


#: every container the port has
CONTAINERS = (DiaMatrix, StencilMatrix, ConstStencilMatrix, EllMatrix, CsrMatrix, CooMatrix,
              BsrMatrix, DenseMatrix)


def is_host(A) -> bool:
    """Whether ``A`` is a container whose arrays are host numpy arrays (one
    to place before a product); a ``ConstStencilMatrix`` has none."""
    data = getattr(A, "data", None)
    return isinstance(A, CONTAINERS) and data is not None and not _is_tensor(data)


def to_host(A):
    """``A`` with every torch tensor field copied to a host numpy array (a
    host container as it is): the relayouts and conversions are host work."""
    if not dataclasses.is_dataclass(A):
        return A
    fields = {}
    for f in dataclasses.fields(A):
        v = getattr(A, f.name)
        if _is_tensor(v):
            import torch

            v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        fields[f.name] = v
    return type(A)(**fields)


# ---------------------------------------------------------------------------
# host-side (numpy) conversions
# ---------------------------------------------------------------------------


def coo_to_csr(coo: CooMatrix, sum_duplicates: bool = True) -> CsrMatrix:
    """Sort COO triplets into CSR, summing duplicates (the DOK builder's
    backend)."""
    n, m = coo.shape
    rows = np.asarray(coo.rows, dtype=np.int64)
    cols = np.asarray(coo.cols, dtype=np.int64)
    data = np.asarray(coo.data)
    order = np.lexsort((cols, rows))
    rows, cols, data = rows[order], cols[order], data[order]
    if sum_duplicates and len(rows) > 0:
        keys = rows * m + cols
        first = np.concatenate(([True], keys[1:] != keys[:-1]))
        group = np.cumsum(first) - 1
        data = np.bincount(group, weights=data, minlength=int(group[-1]) + 1).astype(data.dtype)
        rows, cols = rows[first], cols[first]
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return CsrMatrix(data=data, indices=cols.astype(np.int32), indptr=indptr,
                     row_ids=rows.astype(np.int32), shape=(n, m))


def csr_to_coo(csr: CsrMatrix) -> CooMatrix:
    """CSR -> COO triplets: ``row_ids`` already holds each entry's row."""
    return CooMatrix(data=np.asarray(csr.data), rows=np.asarray(csr.row_ids, dtype=np.int32),
                     cols=np.asarray(csr.indices, dtype=np.int32), shape=csr.shape)


def csr_from_parts(data, indices, indptr, shape: Shape) -> CsrMatrix:
    indptr = np.asarray(indptr, dtype=np.int32)
    n = shape[0]
    row_ids = np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr))
    return CsrMatrix(np.asarray(data), np.asarray(indices, dtype=np.int32), indptr, row_ids, shape)


def csr_to_dense(csr: CsrMatrix) -> DenseMatrix:
    n, m = csr.shape
    out = np.zeros((n, m), dtype=np.asarray(csr.data).dtype)
    np.add.at(out, (np.asarray(csr.row_ids), np.asarray(csr.indices)), np.asarray(csr.data))
    return DenseMatrix(out)


def dense_to_csr(dense: DenseMatrix, tol: float = 0.0) -> CsrMatrix:
    a = np.asarray(dense.data)
    rows, cols = np.nonzero(np.abs(a) > tol)
    return coo_to_csr(CooMatrix(a[rows, cols], rows.astype(np.int32), cols.astype(np.int32),
                                dense.shape))


def csr_to_ell(csr: CsrMatrix, k: int | None = None) -> EllMatrix:
    """CSR -> ELL with the diagonal entry stored first when present.

    The reference's diagonal-first ELL (``Mgcg/HandmadeCL/MgcgCL/
    SparseMatrix.cs:71-88``); raises if a row holds more than ``k`` entries
    (its overflow rule, ``SparseMatrix.cs:138-141``).  Each row's slots hold
    its diagonal entries, then the others, each in CSR order: one stable
    sort over all entries, the same arrays as the JAX package's row loop.
    """
    n, m = csr.shape
    indptr = np.asarray(csr.indptr)
    counts = np.diff(indptr)
    kmax = int(counts.max()) if n else 0
    if k is None:
        k = kmax
    if kmax > k:
        raise ValueError(f"row with {kmax} nonzeros exceeds ELL width k={k}")
    data = np.zeros((n, k), dtype=np.asarray(csr.data).dtype)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, k)) % max(m, 1)
    cdat = np.asarray(csr.data)
    cidx = np.asarray(csr.indices)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    off_diag = (cidx != rows).astype(np.int64)
    order = np.argsort(rows * 2 + off_diag, kind="stable")
    slot = np.arange(len(rows), dtype=np.int64) - indptr[rows].astype(np.int64)
    data[rows, slot] = cdat[order]
    cols[rows, slot] = cidx[order]
    return EllMatrix(data, cols, (n, m))


def ell_to_csr(ell: EllMatrix) -> CsrMatrix:
    n, m = ell.shape
    data = np.asarray(ell.data)
    cols = np.asarray(ell.cols)
    mask = data != 0
    rows = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, ell.k))
    return coo_to_csr(CooMatrix(data[mask], rows[mask], cols[mask].astype(np.int32), (n, m)))


def csr_to_dia(csr: CsrMatrix, offsets: Tuple[int, ...] | None = None) -> DiaMatrix:
    """CSR -> DIA.  ``offsets`` defaults to every structurally present
    diagonal."""
    n, m = csr.shape
    if n != m:
        raise ValueError("DIA requires a square matrix")
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = np.asarray(csr.data)
    diag = cols - rows
    if offsets is None:
        offsets = tuple(int(o) for o in np.unique(diag))
    off_arr = np.asarray(offsets, dtype=np.int64)
    pos = np.searchsorted(off_arr, diag)
    ok = (pos < len(off_arr)) & (off_arr[np.minimum(pos, len(off_arr) - 1)] == diag)
    if not np.all(ok):
        raise ValueError("matrix has entries outside the requested diagonal set")
    data = np.zeros((len(offsets), n), dtype=vals.dtype)
    np.add.at(data, (pos, rows), vals)
    return DiaMatrix(data, tuple(offsets), (n, n))


def dia_to_csr(dia: DiaMatrix) -> CsrMatrix:
    """DIA -> CSR, the structural zeros and stored zeros dropped.  Distinct
    offsets give every row its entries in ascending offset order, which is
    CSR's column order: one masked pass over the legs taken offset by
    offset, no sort (the JAX package's COO lexsort gives the same arrays;
    seconds at the flagship's 33 M entries).  Repeated offsets are summed
    through ``coo_to_csr``."""
    n = dia.n
    data = np.asarray(dia.data)
    if len(set(dia.offsets)) == len(dia.offsets):
        order = np.argsort(np.asarray(dia.offsets, dtype=np.int64), kind="stable")
        offs = np.asarray(dia.offsets, dtype=np.int64)[order]
        legs = data[order].T  # (n, ndiags), offsets ascending along a row
        cols = np.arange(n, dtype=np.int64)[:, None] + offs[None, :]
        keep = (cols >= 0) & (cols < n) & (legs != 0)
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(keep.sum(axis=1), out=indptr[1:])
        return CsrMatrix(legs[keep], cols[keep].astype(np.int32), indptr.astype(np.int32),
                         np.repeat(np.arange(n, dtype=np.int32), np.diff(indptr)), (n, n))
    rows_l, cols_l, vals_l = [], [], []
    for k, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        rows_l.append(i)
        cols_l.append(i + off)
        vals_l.append(data[k, i])
    if rows_l:
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
        vals = np.concatenate(vals_l)
        keep = vals != 0
        rows, cols, vals = rows[keep], cols[keep], vals[keep]
    else:
        rows = cols = np.zeros(0, dtype=np.int64)
        vals = np.zeros(0, dtype=data.dtype)
    return coo_to_csr(CooMatrix(vals, rows.astype(np.int32), cols.astype(np.int32), (n, n)))


def const_to_stencil(cst: ConstStencilMatrix) -> StencilMatrix:
    """Expand to grid-shaped legs, zero where the neighbour exits the grid."""
    coeffs = np.asarray(cst.coeffs)
    legs = np.broadcast_to(
        coeffs.reshape((cst.nlegs,) + (1,) * cst.ndim), (cst.nlegs,) + cst.grid
    ).copy()
    idx = np.indices(cst.grid)
    for k, sh in enumerate(cst.shifts):
        valid = np.ones(cst.grid, dtype=bool)
        for ax, d in enumerate(sh):
            coord = idx[ax] + d
            valid &= (coord >= 0) & (coord < cst.grid[ax])
        legs[k] = np.where(valid, legs[k], 0.0)
    return StencilMatrix(legs, cst.shifts, cst.grid)


def stencil_to_dia(st: StencilMatrix) -> DiaMatrix:
    """Grid stencil -> DIA, offsets ascending; raises when two shifts alias
    one flat offset."""
    strides = _grid_strides(st.grid)
    n = st.n
    data = np.asarray(st.data).reshape(st.nlegs, n)
    offsets = [int(sum(d * t for d, t in zip(s, strides))) for s in st.shifts]
    if len(set(offsets)) != len(offsets):
        raise ValueError(
            f"distinct grid shifts alias the same flat offset on grid {st.grid}; "
            "cannot represent as DIA"
        )
    order = np.argsort(offsets)
    out = np.zeros((st.nlegs, n), dtype=data.dtype)
    i = np.arange(n)
    for slot, k in enumerate(order):
        off = offsets[k]
        valid = (i + off >= 0) & (i + off < n)
        out[slot] = np.where(valid, data[k], 0.0)
    return DiaMatrix(out, tuple(offsets[k] for k in order), (n, n))


def csr_to_bsr(csr: CsrMatrix, block_shape: Tuple[int, int] = (8, 8)) -> BsrMatrix:
    """CSR -> block CSR.  Rows and columns must divide by the block shape;
    blocks with any nonzero are stored dense."""
    n, m = csr.shape
    R, C = block_shape
    if n % R or m % C:
        raise ValueError(f"shape {csr.shape} not divisible by block {block_shape}")
    rows = np.asarray(csr.row_ids, dtype=np.int64)
    cols = np.asarray(csr.indices, dtype=np.int64)
    vals = np.asarray(csr.data)
    brow, bcol = rows // R, cols // C
    keys = brow * (m // C) + bcol
    uniq = np.unique(keys)
    data = np.zeros((len(uniq), R, C), dtype=vals.dtype)
    block_of = np.searchsorted(uniq, keys)
    data[block_of, rows % R, cols % C] = vals
    b_rows = (uniq // (m // C)).astype(np.int32)
    b_cols = (uniq % (m // C)).astype(np.int32)
    indptr = np.zeros(n // R + 1, dtype=np.int32)
    np.add.at(indptr, b_rows + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    return BsrMatrix(data, b_cols, indptr, b_rows, (n, m))


def bsr_to_csr(bsr: BsrMatrix) -> CsrMatrix:
    R, C = bsr.block_shape
    n, m = bsr.shape
    data = np.asarray(bsr.data)
    brows = np.asarray(bsr.block_row_ids, dtype=np.int64)
    bcols = np.asarray(bsr.indices, dtype=np.int64)
    rr, cc = np.meshgrid(np.arange(R), np.arange(C), indexing="ij")
    rows = (brows[:, None, None] * R + rr[None]).ravel()
    cols = (bcols[:, None, None] * C + cc[None]).ravel()
    vals = data.ravel()
    keep = vals != 0
    return coo_to_csr(
        CooMatrix(vals[keep], rows[keep].astype(np.int32), cols[keep].astype(np.int32), (n, m))
    )


def matrix_diagonal(A) -> np.ndarray:
    """The main diagonal of any container, host or device (host numpy)."""
    A = to_host(A)
    if isinstance(A, DiaMatrix):
        return dia_diagonal(A)
    csr = _any_to_csr(A)
    d = np.zeros(csr.n)
    rows = np.asarray(csr.row_ids)
    cols = np.asarray(csr.indices)
    on_diag = rows == cols
    d[rows[on_diag]] = np.asarray(csr.data)[on_diag]
    return d


def jacobi_scaled_dia(A: DiaMatrix):
    """Symmetric Jacobi scaling: ``(A', d_inv_sqrt)`` with
    ``A' = D^{-1/2} A D^{-1/2}`` in the same DIA layout.  Solve
    ``A' y = d_inv_sqrt * b`` and recover ``x = d_inv_sqrt * y``."""
    d = dia_diagonal(A)
    if np.any(d <= 0):
        raise ValueError("symmetric Jacobi scaling needs a positive diagonal")
    dis = (1.0 / np.sqrt(d)).astype(np.asarray(A.data).dtype)
    n = A.n
    data = np.array(np.asarray(A.data), copy=True)
    for k, off in enumerate(A.offsets):
        col = np.zeros(n, dtype=dis.dtype)
        lo, hi = max(0, -off), min(n, n - off)
        col[lo:hi] = dis[lo + off : hi + off]
        data[k] = data[k] * dis * col
    return DiaMatrix(data, A.offsets, A.shape), dis


def transpose(A):
    """A^T in the same storage family (host-side setup work).

    DIA: offset ``o`` becomes ``-o`` and its column rolls by ``o``; CSR,
    ELL, COO and BSR go through a COO row/column swap (ELL stays ELL, the
    others come back as CSR); a stencil round-trips through DIA."""
    if isinstance(A, DiaMatrix):
        data = np.asarray(A.data)
        n = A.n
        out = np.zeros_like(data)
        order = np.argsort([-o for o in A.offsets])
        offsets_t = tuple(-A.offsets[k] for k in order)
        i = np.arange(n)
        for j, k in enumerate(order):
            off = A.offsets[k]
            src = i - off  # A^T[i, i-off] = A[i-off, i] = data[k][i-off]
            ok = (src >= 0) & (src < n)
            out[j, ok] = data[k, src[ok]]
        return DiaMatrix(out, offsets_t, A.shape)
    if isinstance(A, DenseMatrix):
        return DenseMatrix(np.asarray(A.data).T.copy())
    if isinstance(A, StencilMatrix):
        return dia_to_stencil(transpose(stencil_to_dia(A)), A.grid)
    if isinstance(A, ConstStencilMatrix):
        return stencil_to_const(transpose(const_to_stencil(A)))
    csr = _any_to_csr(A)
    coo_t = CooMatrix(data=np.asarray(csr.data), rows=np.asarray(csr.indices, np.int32),
                      cols=np.asarray(csr.row_ids, np.int32), shape=(csr.shape[1], csr.shape[0]))
    out = coo_to_csr(coo_t)
    if isinstance(A, EllMatrix):
        return csr_to_ell(out)
    return out


def is_symmetric(A, tol: float = 0.0) -> bool:
    """``max|A - A^T| <= tol`` for any container, host or device (a host
    diagnostic: a device container is copied to the host first)."""
    import scipy.sparse as sp

    csr = _any_to_csr(to_host(A))
    m = sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)), shape=csr.shape
    )
    d = m - m.T
    return float(np.abs(d.data).max()) <= tol if d.nnz else True


def to_sparse_coo(A):
    """Any container as a ``torch.sparse_coo_tensor`` on the CPU (coalesced:
    row-major, duplicates summed), the interchange with PyTorch's own sparse
    stack."""
    import torch

    if isinstance(A, DenseMatrix):
        return torch.from_numpy(np.array(to_host(A).data)).to_sparse_coo()
    csr = _any_to_csr(to_host(A))
    indices = np.stack([np.asarray(csr.row_ids, dtype=np.int64),
                        np.asarray(csr.indices, dtype=np.int64)])
    return torch.sparse_coo_tensor(torch.from_numpy(indices), torch.from_numpy(np.array(csr.data)),
                                   size=csr.shape, is_coalesced=True, check_invariants=True)


def from_sparse_coo(m) -> CsrMatrix:
    """A ``torch.sparse_coo_tensor`` (any device, coalesced or not) -> host
    CSR, duplicates summed."""
    m = m.detach().cpu()
    indices = (m.indices() if m.is_coalesced() else m._indices()).numpy()
    data = (m.values() if m.is_coalesced() else m._values()).numpy()
    return coo_to_csr(CooMatrix(data, indices[0].astype(np.int32), indices[1].astype(np.int32),
                                (int(m.shape[0]), int(m.shape[1]))))


def _any_to_csr(A) -> CsrMatrix:
    if isinstance(A, CsrMatrix):
        return A
    if isinstance(A, DiaMatrix):
        return dia_to_csr(A)
    if isinstance(A, StencilMatrix):
        return dia_to_csr(stencil_to_dia(A))
    if isinstance(A, ConstStencilMatrix):
        return dia_to_csr(stencil_to_dia(const_to_stencil(A)))
    if isinstance(A, EllMatrix):
        return ell_to_csr(A)
    if isinstance(A, CooMatrix):
        return coo_to_csr(A)
    if isinstance(A, BsrMatrix):
        return bsr_to_csr(A)
    if isinstance(A, DenseMatrix):
        return dense_to_csr(A)
    raise TypeError(f"cannot convert {type(A)} to CSR")
