"""Host-side (numpy) sparse containers for the PyTorch port.

The counterparts of ``conjugategradient_tpu/core/formats.py`` that the
ported slices need: ``DiaMatrix``, ``StencilMatrix`` and
``ConstStencilMatrix`` plus the conversions between them.  They are plain
frozen dataclasses over numpy arrays: setup stays on the host.
``DiaMatrix.device_put`` gives the device-resident flat banded operator (its
``data`` a torch tensor, as the JAX package's holds a ``jnp`` array);
``ConstStencilMatrix`` has no array data at all (its coefficients, shifts and
grid are static Python values that the CUDA kernels take by value).

The code is a numpy-only copy of the JAX package's host helpers (that package
imports ``jax`` at its root, which the GPU machine does not have); the
differential tests hold the two to the same results.
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
    def dtype(self):
        return self.data.dtype

    def astype(self, dtype) -> "DiaMatrix":
        return DiaMatrix(self.data.astype(dtype), self.offsets, self.shape)

    def device_put(self, dtype=None, device="cpu") -> "DiaMatrix":
        """A ``DiaMatrix`` whose ``data`` is a contiguous torch tensor on
        ``device``, cast to ``dtype`` (a numpy or torch dtype, e.g.
        ``torch.bfloat16`` for a half-width matrix stream).  Same dtype on
        the CPU shares memory with the numpy array."""
        import torch

        data = self.data if torch.is_tensor(self.data) else torch.from_numpy(np.asarray(self.data))
        dt = data.dtype if dtype is None else torch_dtype(dtype)
        return DiaMatrix(data.to(device=device, dtype=dt).contiguous(), self.offsets, self.shape)


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
    exact zeros where the neighbour exits the grid.  In this slice it is only
    setup state: ``build_hierarchy`` const-detects every level from it.
    """

    data: np.ndarray  # (nlegs, *grid)
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


def dia_to_dense(dia: DiaMatrix) -> np.ndarray:
    """Dense ``(n, n)`` array of a DIA matrix (the coarsest-level inverse)."""
    n = dia.n
    data = np.asarray(dia.data)
    out = np.zeros((n, n), dtype=data.dtype)
    for k, off in enumerate(dia.offsets):
        i = np.arange(max(0, -off), min(n, n - off))
        out[i, i + off] = data[k, i]
    return out


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
