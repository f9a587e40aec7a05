"""Deterministic SPD systems (numpy, host-side).

A copy of the parts of ``conjugategradient_tpu/core/generators.py`` that the
ported slices run: the banded ``|sin(i+j)|`` and tridiagonal systems of the
reference's drivers, and the Poisson matrices of the multigrid path.  The
same numpy code, so the systems are bit-identical to the JAX package's (the
tests compare them element by element).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from conjugategradient_tpu_torch.core.formats import DiaMatrix


@dataclasses.dataclass(frozen=True)
class LinearSystem:
    """A = SPD matrix, b = RHS, x0 = initial guess."""

    A: DiaMatrix
    b: np.ndarray
    x0: np.ndarray

    @property
    def n(self) -> int:
        return self.A.n


def banded_sin_matrix(n: int, band: int, dtype=np.float64) -> DiaMatrix:
    """The ``a_ij = |sin(i+j)|`` banded matrix with row-sum diagonal.

    Off-diagonals live at ``j in [max(0, i - band/2 + 1), min(n, i + band/2))``
    with ``j != i``, and the diagonal is the sum of the row's off-diagonal
    magnitudes (``Mgcg/cuBlas/Mgcg/MgcgMain.cs:53-84``).
    """
    offsets, data = banded_sin_rows(n, band, 0, n, dtype=dtype)
    return DiaMatrix(data, offsets, (n, n))


def banded_sin_rows(n: int, band: int, lo: int, hi: int, dtype=np.float64):
    """(offsets, data columns) for rows [lo, hi) of ``banded_sin_matrix``."""
    if band < 2 or band % 2:
        raise ValueError("band must be an even integer >= 2")
    h = band // 2 - 1  # half-width of the off-diagonal band
    offsets = tuple(range(-h, h + 1))
    i = np.arange(lo, hi, dtype=np.int64)
    data = np.zeros((len(offsets), hi - lo), dtype=dtype)
    diag_k = offsets.index(0)
    for k, off in enumerate(offsets):
        if off == 0:
            continue
        valid = (i + off >= 0) & (i + off < n)
        vals = np.abs(np.sin((2 * i + off).astype(dtype)))
        data[k] = np.where(valid, vals, 0.0)
        data[diag_k] += data[k]
    return offsets, data


def banded_sin_system(
    n: int,
    band: int,
    b_kind: str = "cos10",
    x0_kind: str = "i/100",
    dtype=np.float64,
) -> LinearSystem:
    """Matrix plus the drivers' RHS and initial-guess recipes.

    ``b_kind``:  ``cos10`` = 10*cos(i) (``MgcgMain.cs:94``);
                 ``one_plus`` = 1 + 0.1*i (ViennaCL small);
                 ``asin`` = asin(i/n) (ViennaCL large).
    ``x0_kind``: ``i/100`` (``MgcgMain.cs:99``), ``i/10`` (``R/CG.R:21``),
                 ``zeros``.
    """
    A = banded_sin_matrix(n, band, dtype=dtype)
    i = np.arange(n, dtype=dtype)
    if b_kind == "cos10":
        b = 10.0 * np.cos(i)
    elif b_kind == "one_plus":
        b = 1.0 + 0.1 * i
    elif b_kind == "asin":
        b = np.arcsin(i / n)
    else:
        raise ValueError(f"unknown b_kind {b_kind!r}")
    if x0_kind == "i/100":
        x0 = i / 100.0
    elif x0_kind == "i/10":
        x0 = i / 10.0
    elif x0_kind == "zeros":
        x0 = np.zeros(n, dtype=dtype)
    else:
        raise ValueError(f"unknown x0_kind {x0_kind!r}")
    return LinearSystem(A, b.astype(dtype), x0.astype(dtype))


def tridiagonal_matrix(n: int, diag: float = 2.0, off: float = 1.0, dtype=np.float64) -> DiaMatrix:
    """The (2, 1) tridiagonal SPD matrix of the standalone CUDA demo
    (``SimpleConjugateGradient.cu:163-190``)."""
    _, data = tridiagonal_rows(n, 0, n, diag=diag, off=off, dtype=dtype)
    return DiaMatrix(data, (-1, 0, 1), (n, n))


def tridiagonal_rows(n: int, lo: int, hi: int, diag: float = 2.0, off: float = 1.0, dtype=np.float64):
    """(offsets, data columns) for rows [lo, hi) of the tridiagonal matrix."""
    i = np.arange(lo, hi, dtype=np.int64)
    data = np.zeros((3, hi - lo), dtype=dtype)
    data[0] = np.where(i >= 1, off, 0.0)  # A[i, i-1]
    data[1] = diag
    data[2] = np.where(i <= n - 2, off, 0.0)  # A[i, i+1]
    return (-1, 0, 1), data


def tridiagonal_system(n: int, dtype=np.float64) -> LinearSystem:
    """Tridiagonal workload: ``b_i = i^2 / 2``, ``x0 = 0``
    (``SimpleConjugateGradient.cu:196,203``)."""
    i = np.arange(n, dtype=dtype)
    return LinearSystem(tridiagonal_matrix(n, dtype=dtype), 0.5 * i * i, np.zeros(n, dtype=dtype))


def poisson1d_matrix(nx: int, dtype=np.float64) -> DiaMatrix:
    """1-D Laplacian (-1, 2, -1), Dirichlet, unit grid spacing."""
    data = np.zeros((3, nx), dtype=dtype)
    data[0, 1:] = -1.0
    data[1, :] = 2.0
    data[2, : nx - 1] = -1.0
    return DiaMatrix(data, (-1, 0, 1), (nx, nx))


def poisson2d_matrix(nx: int, ny: int | None = None, dtype=np.float64) -> DiaMatrix:
    """2-D 5-point Laplacian on an ``ny x nx`` grid (row-major, Dirichlet)."""
    ny = nx if ny is None else ny
    n = nx * ny
    offsets, data = poisson2d_rows(nx, ny, 0, n, dtype=dtype)
    return DiaMatrix(data, offsets, (n, n))


def poisson2d_rows(nx: int, ny: int, lo: int, hi: int, dtype=np.float64):
    """(offsets, data columns) for flat rows [lo, hi) of the 2-D Laplacian.
    int32 coordinates and bool->dtype assignment keep the temporaries small
    on large grids."""
    idt = np.int32 if hi <= np.iinfo(np.int32).max else np.int64
    i = np.arange(lo, hi, dtype=idt)
    x = i % idt(nx)
    y = i // idt(nx)
    del i
    data = np.zeros((5, hi - lo), dtype=dtype)
    data[0] = y >= 1  # A[i, i-nx]
    data[1] = x >= 1  # A[i, i-1]
    data[3] = x <= nx - 2  # A[i, i+1]
    data[4] = y <= ny - 2  # A[i, i+nx]
    np.negative(data, out=data)
    data[2] = 4.0
    return (-nx, -1, 0, 1, nx), data


def poisson3d_matrix(nx: int, ny: int | None = None, nz: int | None = None, dtype=np.float64) -> DiaMatrix:
    """3-D 7-point Laplacian on ``nz x ny x nx`` (row-major, Dirichlet)."""
    ny = nx if ny is None else ny
    nz = nx if nz is None else nz
    n = nx * ny * nz
    offsets, data = poisson3d_rows(nx, ny, nz, 0, n, dtype=dtype)
    return DiaMatrix(data, offsets, (n, n))


def poisson3d_rows(nx: int, ny: int, nz: int, lo: int, hi: int, dtype=np.float64):
    """(offsets, data columns) for flat rows [lo, hi) of the 3-D Laplacian."""
    idt = np.int32 if hi <= np.iinfo(np.int32).max else np.int64
    i = np.arange(lo, hi, dtype=idt)
    x = i % idt(nx)
    i //= idt(nx)  # reuse as i // nx
    y = i % idt(ny)
    i //= idt(ny)  # now z
    z = i
    data = np.zeros((7, hi - lo), dtype=dtype)
    data[0] = z >= 1
    data[1] = y >= 1
    data[2] = x >= 1
    data[4] = x <= nx - 2
    data[5] = y <= ny - 2
    data[6] = z <= nz - 2
    np.negative(data, out=data)
    data[3] = 6.0
    return (-nx * ny, -nx, -1, 0, 1, nx, nx * ny), data


def _poisson_matrix(grid_shape: Tuple[int, ...], dtype) -> DiaMatrix:
    if len(grid_shape) == 1:
        return poisson1d_matrix(grid_shape[0], dtype=dtype)
    if len(grid_shape) == 2:
        return poisson2d_matrix(grid_shape[1], grid_shape[0], dtype=dtype)
    if len(grid_shape) == 3:
        return poisson3d_matrix(grid_shape[2], grid_shape[1], grid_shape[0], dtype=dtype)
    raise ValueError("grid_shape must be 1-, 2- or 3-D")


def poisson_system(grid_shape: Tuple[int, ...], seed: int = 0, dtype=np.float64) -> LinearSystem:
    """Poisson workload with a deterministic smooth RHS and zero initial guess."""
    A = _poisson_matrix(tuple(grid_shape), dtype)
    n = A.n
    i = np.arange(n, dtype=dtype)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return LinearSystem(A, b.astype(dtype), np.zeros(n, dtype=dtype))


def poisson_coarse_operator(dtype=np.float64):
    """Rediscretization hook for ``precond.build_hierarchy(coarse_operator=)``
    on the constant-coefficient Poisson ladder: level ``l`` is
    ``0.25**l * A_gen(grid_l)``, the fw-transfer diffusion scale per level.
    Every level stays a (2d+1)-point const stencil."""

    def cb(level: int, coarse_grid: Tuple[int, ...]) -> DiaMatrix:
        g = tuple(coarse_grid)
        if len(g) not in (1, 2, 3):
            raise ValueError("poisson rediscretization is 1/2/3-D only")
        A = _poisson_matrix(g, dtype)
        return DiaMatrix(
            np.asarray(A.data) * np.asarray(0.25 ** level, dtype=dtype),
            A.offsets,
            A.shape,
        )

    return cb
