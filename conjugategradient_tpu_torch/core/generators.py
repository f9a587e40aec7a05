"""Deterministic test systems (numpy, host-side).

A copy of the parts of ``conjugategradient_tpu/core/generators.py`` that the
ported slices run: the banded ``|sin(i+j)|`` and tridiagonal systems of the
reference's drivers, the Poisson matrices of the multigrid path and the
variable-coefficient diffusion family of the Galerkin MGCG path, the
anisotropic Laplacian of the semicoarsening path, and the nonsymmetric and
indefinite systems of the Krylov family (convection-diffusion, Helmholtz,
the nonsymmetric banded twin), the per-row-block generators
(``b_rows``, ``x0_rows``, ``system_rows``) behind the sharded assembly,
and the per-slab convection generators behind the rung-5 assembly
(``convection_diffusion_level_slab``, ``convection_diffusion_rhs_slab``).  The
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
    """A = system matrix, b = RHS, x0 = initial guess."""

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


# ---------------------------------------------------------------------------
# Variable-coefficient diffusion: -div(a grad u) = f on a tensor grid,
# node-centered coefficients, harmonic-mean face weights, Dirichlet
# boundaries.  The variable-coefficient workload, whose legs stream matrix
# bytes (kernel #3) and whose hierarchy is built by the Galerkin product.
# ---------------------------------------------------------------------------


def diffusion_coefficients(
    grid_shape: Tuple[int, ...],
    kind: str = "jump",
    contrast: float = 1e3,
    seed: int = 0,
    dtype=np.float64,
) -> np.ndarray:
    """Positive node-centered coefficient field ``a`` on ``grid_shape``.

    ``kind="jump"``: piecewise-constant log-uniform values in
    ``[1, contrast]`` on a coarse 4^d block partition.  ``kind="smooth"``: a
    smooth ``exp(sin)`` product field with max/min ratio ~= e^2 per axis.
    ``kind="const"``: all ones (the Poisson Laplacian).
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    if kind == "const":
        return np.ones(grid_shape, dtype=dtype)
    if kind == "smooth":
        a = np.ones(grid_shape, dtype=np.float64)
        for ax, g in enumerate(grid_shape):
            t = np.linspace(0.0, 2.0 * np.pi, g)
            shape = [1] * len(grid_shape)
            shape[ax] = g
            a = a * np.exp(np.sin(t + 0.7 * ax + seed)).reshape(shape)
        return a.astype(dtype)
    if kind == "jump":
        rng = np.random.default_rng(seed)
        blocks = tuple(max(1, (g + 3) // 4) for g in grid_shape)  # ~4 cells/axis
        vals = np.exp(
            rng.uniform(0.0, np.log(max(contrast, 1.0 + 1e-12)), size=blocks)
        )
        idx = np.ix_(
            *[np.minimum(np.arange(g) * b // g, b - 1) for g, b in zip(grid_shape, blocks)]
        )
        return vals[idx].astype(dtype)
    raise ValueError(f"unknown coefficient kind {kind!r}")


def diffusion_matrix(grid_shape: Tuple[int, ...], a: np.ndarray, dtype=np.float64) -> DiaMatrix:
    """SPD discretization of ``-div(a grad u)`` with Dirichlet boundaries.

    Unit grid spacing; the face weight between neighbouring nodes is the
    harmonic mean ``2 a_i a_j / (a_i + a_j)``, boundary faces use the node's
    own ``a``.  Row ``i``: diagonal = sum of its 2d face weights,
    off-diagonal ``-w_face`` per in-grid neighbour: a symmetric M-matrix,
    positive definite via the strictly positive boundary faces.  Offsets are
    the row-major axis strides, so ``dia_to_stencil`` maps it to a
    (2d+1)-leg ``StencilMatrix``.
    """
    grid_shape = tuple(int(g) for g in grid_shape)
    d = len(grid_shape)
    a = np.asarray(a, dtype=np.float64).reshape(grid_shape)
    if np.any(a <= 0):
        raise ValueError("diffusion coefficients must be strictly positive")
    n = int(np.prod(grid_shape))
    strides = [int(np.prod(grid_shape[ax + 1 :])) for ax in range(d)]

    diag = np.zeros(grid_shape, dtype=np.float64)
    legs: dict[int, np.ndarray] = {}
    for ax in range(d):
        lo = [slice(None)] * d
        hi = [slice(None)] * d
        lo[ax] = slice(None, -1)  # node i  (face between i and i+1)
        hi[ax] = slice(1, None)  # node i+1
        lo, hi = tuple(lo), tuple(hi)
        w = 2.0 * a[lo] * a[hi] / (a[lo] + a[hi])
        plus = np.zeros(grid_shape, dtype=np.float64)  # A[i, i+stride]
        minus = np.zeros(grid_shape, dtype=np.float64)  # A[i, i-stride]
        plus[lo] = w
        minus[hi] = w
        diag += plus + minus
        first = [slice(None)] * d
        last = [slice(None)] * d
        first[ax] = 0
        last[ax] = grid_shape[ax] - 1
        diag[tuple(first)] += a[tuple(first)]  # Dirichlet boundary faces
        diag[tuple(last)] += a[tuple(last)]
        legs[strides[ax]] = -plus
        legs[-strides[ax]] = -minus
    legs[0] = diag

    offsets = tuple(sorted(legs))
    data = np.stack([legs[o].reshape(-1) for o in offsets]).astype(dtype)
    return DiaMatrix(data, offsets, (n, n))


def diffusion_system(
    grid_shape: Tuple[int, ...],
    kind: str = "jump",
    contrast: float = 1e3,
    seed: int = 0,
    dtype=np.float64,
) -> LinearSystem:
    """Diffusion workload: coefficient field per ``kind``, smooth RHS, x0=0."""
    a = diffusion_coefficients(grid_shape, kind=kind, contrast=contrast, seed=seed)
    A = diffusion_matrix(grid_shape, a, dtype=dtype)
    n = A.n
    i = np.arange(n, dtype=np.float64)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return LinearSystem(A, b.astype(dtype), np.zeros(n, dtype=dtype))


def anisotropic_diffusion_matrix(
    grid_shape: Tuple[int, ...], ratios, dtype=np.float64
) -> DiaMatrix:
    """Constant-coefficient anisotropic Laplacian ``-sum_ax a_ax d2u/dx_ax2``
    (Dirichlet, unit spacing), one coefficient per grid axis in ``ratios``:
    the semicoarsening workload (point smoothers leave error smooth only
    along the strongly coupled axes)."""
    grid_shape = tuple(grid_shape)
    ratios = tuple(float(a) for a in ratios)
    if len(ratios) != len(grid_shape):
        raise ValueError(f"need {len(grid_shape)} ratios, got {len(ratios)}")
    n = int(np.prod(grid_shape))
    idx = np.indices(grid_shape).reshape(len(grid_shape), n)
    strides = [int(np.prod(grid_shape[ax + 1:])) for ax in range(len(grid_shape))]
    offsets, rows = [], []
    for ax in range(len(grid_shape)):
        offsets.append(-strides[ax])
        rows.append(np.where(idx[ax] >= 1, -ratios[ax], 0.0))
    offsets.append(0)
    rows.append(np.full(n, 2.0 * sum(ratios)))
    for ax in range(len(grid_shape) - 1, -1, -1):
        offsets.append(strides[ax])
        rows.append(np.where(idx[ax] <= grid_shape[ax] - 2, -ratios[ax], 0.0))
    order = np.argsort(offsets)
    data = np.stack([rows[k] for k in order]).astype(dtype)
    return DiaMatrix(data, tuple(int(offsets[k]) for k in order), (n, n))


def anisotropic_diffusion_system(
    grid_shape: Tuple[int, ...], ratios, seed: int = 0, dtype=np.float64
) -> LinearSystem:
    """The anisotropic Laplacian with the smooth Poisson-family RHS, x0=0."""
    A = anisotropic_diffusion_matrix(grid_shape, ratios, dtype=dtype)
    n = A.n
    i = np.arange(n, dtype=np.float64)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return LinearSystem(A, b.astype(dtype), np.zeros(n, dtype=dtype))


# ---------------------------------------------------------------------------
# Nonsymmetric and indefinite workloads: convection-diffusion (upwind or
# central, 2-D and 3-D, with its rediscretization hook), the shifted
# Laplacian and the nonsymmetric twin of the banded |sin| matrix.
# ---------------------------------------------------------------------------


def convection_diffusion_rows(
    grid_shape: Tuple[int, int],
    lo: int,
    hi: int,
    eps: float = 1.0,
    velocity="recirculating",
    scheme: str = "upwind",
    dtype=np.float64,
):
    """(offsets, data columns) for flat rows [lo, hi) of the 2-D
    convection-diffusion operator — closed-form in the row index (the
    recirculating field's normaliser ``sqrt(cx^2 + cy^2)`` is attained at
    the grid corners, so no global pass is needed), like
    ``poisson2d_rows``."""
    ny, nx = grid_shape
    i = np.arange(lo, hi, dtype=np.int64)
    gx = (i % nx).astype(np.float64)
    gy = (i // nx).astype(np.float64)
    if velocity == "recirculating":
        cx, cy = (nx - 1) / 2.0, (ny - 1) / 2.0
        vx = gy - cy
        vy = -(gx - cx)
        speed = np.sqrt(cx * cx + cy * cy)  # max over the grid (corners)
        if speed > 0:
            vx, vy = vx / speed, vy / speed
    else:
        vx = np.full(hi - lo, float(velocity[0]))
        vy = np.full(hi - lo, float(velocity[1]))
    if scheme == "upwind":
        west = -eps - np.maximum(vx, 0.0)
        east = -eps - np.maximum(-vx, 0.0)
        south = -eps - np.maximum(vy, 0.0)
        north = -eps - np.maximum(-vy, 0.0)
        diag = 4.0 * eps + np.abs(vx) + np.abs(vy)
    elif scheme == "central":
        west = -eps - 0.5 * vx
        east = -eps + 0.5 * vx
        south = -eps - 0.5 * vy
        north = -eps + 0.5 * vy
        diag = np.full(hi - lo, 4.0 * eps)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    x, y = i % nx, i // nx
    data = np.zeros((5, hi - lo), dtype=dtype)
    data[0] = np.where(y >= 1, south, 0.0)  # A[i, i-nx]
    data[1] = np.where(x >= 1, west, 0.0)  # A[i, i-1]
    data[2] = diag
    data[3] = np.where(x <= nx - 2, east, 0.0)  # A[i, i+1]
    data[4] = np.where(y <= ny - 2, north, 0.0)  # A[i, i+nx]
    return (-nx, -1, 0, 1, nx), data


def convection_diffusion3d_rows(
    grid_shape: Tuple[int, int, int],
    lo: int,
    hi: int,
    eps: float = 1.0,
    velocity="recirculating",
    scheme: str = "upwind",
    dtype=np.float64,
):
    """(offsets, data columns) for flat rows [lo, hi) of the 3-D
    convection-diffusion operator on an ``nz x ny x nx`` grid (7-point
    layout like ``poisson3d_rows``).  The recirculating field rotates
    about the z-axis: ``v = (y - cy, -(x - cx), 0) / corner_speed`` —
    closed-form in the row index like the 2-D version."""
    nz, ny, nx = grid_shape
    i = np.arange(lo, hi, dtype=np.int64)
    x = i % nx
    y = (i // nx) % ny
    z = i // (nx * ny)
    if velocity == "recirculating":
        cx, cy = (nx - 1) / 2.0, (ny - 1) / 2.0
        vx = y.astype(np.float64) - cy
        vy = -(x.astype(np.float64) - cx)
        vz = np.zeros(hi - lo)
        speed = np.sqrt(cx * cx + cy * cy)
        if speed > 0:
            vx, vy = vx / speed, vy / speed
    else:
        vx = np.full(hi - lo, float(velocity[0]))
        vy = np.full(hi - lo, float(velocity[1]))
        vz = np.full(hi - lo, float(velocity[2]))
    if scheme == "upwind":
        west = -eps - np.maximum(vx, 0.0)
        east = -eps - np.maximum(-vx, 0.0)
        south = -eps - np.maximum(vy, 0.0)
        north = -eps - np.maximum(-vy, 0.0)
        down = -eps - np.maximum(vz, 0.0)
        up = -eps - np.maximum(-vz, 0.0)
        diag = 6.0 * eps + np.abs(vx) + np.abs(vy) + np.abs(vz)
    elif scheme == "central":
        west, east = -eps - 0.5 * vx, -eps + 0.5 * vx
        south, north = -eps - 0.5 * vy, -eps + 0.5 * vy
        down, up = -eps - 0.5 * vz, -eps + 0.5 * vz
        diag = np.full(hi - lo, 6.0 * eps)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    data = np.zeros((7, hi - lo), dtype=dtype)
    data[0] = np.where(z >= 1, down, 0.0)
    data[1] = np.where(y >= 1, south, 0.0)
    data[2] = np.where(x >= 1, west, 0.0)
    data[3] = diag
    data[4] = np.where(x <= nx - 2, east, 0.0)
    data[5] = np.where(y <= ny - 2, north, 0.0)
    data[6] = np.where(z <= nz - 2, up, 0.0)
    return (-nx * ny, -nx, -1, 0, 1, nx, nx * ny), data


def convection_diffusion_matrix(
    grid_shape: Tuple[int, int],
    eps: float = 1.0,
    velocity="recirculating",
    scheme: str = "upwind",
    dtype=np.float64,
) -> DiaMatrix:
    """Convection-diffusion ``-eps * lap(u) + v . grad(u)`` on a 2-D
    ``ny x nx`` (5-point) or 3-D ``nz x ny x nx`` (7-point) unit-spacing
    grid, Dirichlet boundaries, DIA layout exactly like the Poisson
    builders.

    ``velocity``: ``"recirculating"`` — the classic rotating field
    ``v(x, y) = (y - cy, -(x - cx))`` scaled to max speed 1 (circulation
    makes the skew part non-trivial everywhere); or a constant ``(vx, vy)``
    tuple.  ``scheme``: ``"upwind"`` (first-order, diagonally dominant
    M-matrix at any Peclet number — the robust default) or ``"central"``
    (second-order; loses diagonal dominance when cell Peclet ``|v|/eps``
    exceeds 2 — the hard GMRES/BiCGStab stress case).

    The cell Peclet number ``max|v| / eps`` controls nonnormality: eps >> 1
    is a perturbed Laplacian, eps << 1 is transport-dominated.
    """
    n = int(np.prod(grid_shape))
    rows = (
        convection_diffusion_rows
        if len(grid_shape) == 2
        else convection_diffusion3d_rows
    )
    offsets, data = rows(
        tuple(grid_shape), 0, n, eps=eps, velocity=velocity, scheme=scheme,
        dtype=dtype,
    )
    return DiaMatrix(data, offsets, (n, n))


def convection_diffusion_coarse_operator(
    eps: float,
    velocity="recirculating",
    scheme: str = "upwind",
    dtype=np.float64,
):
    """Rediscretization hook for ``precond.build_hierarchy(coarse_operator=)``
    on the convection-diffusion family.

    Galerkin coarsening of an upwind transport operator is UNSTABLE past
    cell Peclet ~1: the product operator behaves like an under-dissipated
    higher-order scheme on the doubled mesh, the coarse-grid correction
    amplifies, and the mg_* preconditioned solves diverge from 127x127 up
    (measured; 63x63 still converges).  Rediscretizing every level with the
    first-order upwind generator keeps each coarse operator an M-matrix at
    ANY Peclet — the classic geometric-MG remedy (Trottenberg et al.,
    *Multigrid* §7).

    The per-level scaling matches this builder's fw transfer convention
    (measured stencil-moment factors: diffusion 1/4, convection 1/2 per
    level, identical in 1/2/3-D):

        A_{l+1} = 0.5 * A_gen(eps_l / 2, v)   i.e.  eps_l = eps / 2**l,
        cumulative scale 0.5**l

    — cell Peclet doubles per level exactly as physical coarsening demands.
    ``scheme`` defaults to upwind regardless of the fine discretization:
    a central fine operator with upwind coarse levels is the standard
    defect-correction pairing (the preconditioner only needs stability).
    """

    def cb(level: int, coarse_grid: Tuple[int, ...]) -> DiaMatrix:
        A = convection_diffusion_matrix(
            tuple(coarse_grid), eps=eps / (2.0 ** level), velocity=velocity,
            scheme=scheme, dtype=dtype,
        )
        return DiaMatrix(
            np.asarray(A.data) * np.asarray(0.5 ** level, dtype=dtype),
            A.offsets, A.shape,
        )

    return cb


def convection_diffusion_level_slab(
    eps: float,
    velocity="recirculating",
    scheme: str = "upwind",
    dtype=np.float32,
):
    """Per-slab assembly callback for sharded rediscretized hierarchies
    (``precond.distributed.build_hierarchy_redisc``): returns
    ``slab(level, grid_l, lo0, hi0) -> (nlegs, hi0-lo0, *grid_l[1:])``
    stencil legs for axis-0 planes [lo0, hi0) of hierarchy level ``level``.

    Level ``l`` carries the calibrated rediscretization
    (``convection_diffusion_coarse_operator``): ``0.5**l *
    A_gen(eps / 2**l, v)``.  Leg order is sorted unit shifts, the DIA
    offset order of the rows builders and ``dia_to_stencil``'s order
    (``parallel.rung5.unit_shifts``).  Closed form in the row index, so no
    host holds a whole level."""

    def slab(level: int, grid_l, lo0: int, hi0: int) -> np.ndarray:
        grid_l = tuple(grid_l)
        rows = (
            convection_diffusion_rows
            if len(grid_l) == 2
            else convection_diffusion3d_rows
        )
        stride = int(np.prod(grid_l[1:]))
        _offs, data = rows(
            grid_l, lo0 * stride, hi0 * stride, eps=eps / (2.0 ** level),
            velocity=velocity, scheme=scheme, dtype=dtype,
        )
        data = data * np.asarray(0.5 ** level, dtype=dtype)
        return data.reshape((data.shape[0], hi0 - lo0) + grid_l[1:])

    return slab


def convection_diffusion_rhs_slab(
    grid, lo0: int, hi0: int, dtype=np.float32, seed: int = 0
) -> np.ndarray:
    """Axis-0 slab [lo0, hi0) of ``convection_diffusion_system``'s
    right-hand side (closed form in the flat index; the convection twin of
    ``parallel.rung5.poisson_rhs_slab``)."""
    grid = tuple(grid)
    stride = int(np.prod(grid[1:]))
    i = np.arange(lo0 * stride, hi0 * stride, dtype=np.float64)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return b.astype(dtype).reshape((hi0 - lo0,) + grid[1:])


def convection_diffusion_system(
    grid_shape: Tuple[int, int],
    eps: float = 0.05,
    velocity="recirculating",
    scheme: str = "upwind",
    seed: int = 0,
    dtype=np.float64,
) -> LinearSystem:
    """Convection-diffusion workload with the smooth Poisson-family RHS."""
    A = convection_diffusion_matrix(
        grid_shape, eps=eps, velocity=velocity, scheme=scheme, dtype=dtype
    )
    n = A.n
    i = np.arange(n, dtype=np.float64)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return LinearSystem(A, b.astype(dtype), np.zeros(n, dtype=dtype))


def helmholtz_matrix(
    grid_shape: Tuple[int, ...], shift: float, dtype=np.float64
) -> DiaMatrix:
    """Shifted Laplacian ``-lap(u) - shift * u`` (Dirichlet, unit spacing):
    symmetric, and INDEFINITE once ``shift`` exceeds the smallest Laplacian
    eigenvalue — the canonical ``solvers.minres`` workload (a Helmholtz
    operator at wavenumber ``k = sqrt(shift)``).  Same DIA layout as the
    Poisson family."""
    if len(grid_shape) == 1:
        A = poisson1d_matrix(grid_shape[0], dtype=np.float64)
    elif len(grid_shape) == 2:
        A = poisson2d_matrix(grid_shape[1], grid_shape[0], dtype=np.float64)
    else:
        A = poisson3d_matrix(
            grid_shape[2], grid_shape[1], grid_shape[0], dtype=np.float64
        )
    data = np.asarray(A.data, np.float64).copy()
    diag_k = A.offsets.index(0)
    data[diag_k] -= float(shift)
    return DiaMatrix(data.astype(dtype), A.offsets, A.shape)


def helmholtz_rows(
    grid_shape: Tuple[int, ...], shift: float, lo: int, hi: int, dtype=np.float64
):
    """(offsets, data columns) for rows [lo, hi) of the shifted Laplacian —
    the Poisson row recipes with the diagonal shifted (per-row-block form)."""
    g = tuple(grid_shape)
    if len(g) == 1:
        offsets, data = tridiagonal_rows(g[0], lo, hi, diag=2.0, off=-1.0, dtype=dtype)
    elif len(g) == 2:
        offsets, data = poisson2d_rows(g[1], g[0], lo, hi, dtype=dtype)
    else:
        offsets, data = poisson3d_rows(g[2], g[1], g[0], lo, hi, dtype=dtype)
    data[offsets.index(0)] -= shift
    return offsets, data


def helmholtz_system(
    grid_shape: Tuple[int, ...], shift: float, seed: int = 0, dtype=np.float64
) -> LinearSystem:
    A = helmholtz_matrix(grid_shape, shift, dtype=dtype)
    n = A.n
    i = np.arange(n, dtype=np.float64)
    b = np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)
    return LinearSystem(A, b.astype(dtype), np.zeros(n, dtype=dtype))


def outlier_system(
    n: int,
    band: int = 16,
    n_outliers: int = 4,
    scale: float = 1e-3,
    seed: int = 0,
    dtype=np.float64,
) -> LinearSystem:
    """SPD system with a few isolated tiny eigenvalues: the banded |sin|
    matrix under a symmetric diagonal scaling D A D with ``n_outliers``
    entries of D set to about ``scale`` (the rest 1).

    The weakly-coupled-unknown archetype (near-floating subregions, high
    density contrast): kappa grows by about ``scale**-2`` through a handful
    of outlier modes while the bulk spectrum stays as it was.  The
    workload ``solvers.deflation`` targets.
    """
    A = banded_sin_matrix(n, band, dtype=np.float64)
    rng = np.random.default_rng(seed)
    idx = rng.choice(n, size=n_outliers, replace=False)
    d = np.ones(n)
    d[idx] = scale * (1.0 + 0.5 * rng.random(n_outliers))
    data = np.asarray(A.data, np.float64).copy()
    i = np.arange(n)
    for k, off in enumerate(A.offsets):
        j = i + off
        valid = (j >= 0) & (j < n)
        data[k, valid] *= d[i[valid]] * d[np.clip(j, 0, n - 1)[valid]]
    As = DiaMatrix(data.astype(dtype), A.offsets, A.shape)
    b = rng.standard_normal(n)
    return LinearSystem(As, b.astype(dtype), np.zeros(n, dtype=dtype))


def nonsymmetric_banded_matrix(n: int, band: int, dtype=np.float64) -> DiaMatrix:
    """Nonsymmetric twin of ``banded_sin_matrix``: ``a_ij = |sin(i + 2j)| / 2``
    off the diagonal (note ``sin(i + 2j) != sin(j + 2i)``), diagonal = row-sum
    of off-diagonal magnitudes + 1.  Row diagonal dominance puts every
    eigenvalue in the open right half-plane (Gershgorin), so the matrix is
    nonsingular and GMRES/BiCGStab-friendly while remaining genuinely
    nonsymmetric at every band position.
    """
    if band < 2 or band % 2:
        raise ValueError("band must be an even integer >= 2")
    h = band // 2 - 1
    offsets = tuple(range(-h, h + 1))
    i = np.arange(n, dtype=np.int64)
    data = np.zeros((len(offsets), n), dtype=dtype)
    diag_k = offsets.index(0)
    for k, off in enumerate(offsets):
        if off == 0:
            continue
        valid = (i + off >= 0) & (i + off < n)
        vals = 0.5 * np.abs(np.sin((i + 2 * (i + off)).astype(np.float64)))
        data[k] = np.where(valid, vals, 0.0).astype(dtype)
        data[diag_k] += data[k]
    data[diag_k] += 1.0
    return DiaMatrix(data, offsets, (n, n))


def nonsymmetric_banded_system(n: int, band: int, dtype=np.float64) -> LinearSystem:
    A = nonsymmetric_banded_matrix(n, band, dtype=dtype)
    i = np.arange(n, dtype=dtype)
    return LinearSystem(A, (10.0 * np.cos(i)).astype(dtype), np.zeros(n, dtype=dtype))


# ---------------------------------------------------------------------------
# Per-row-block generation: every generator above is a closed form in the row
# index, so any [lo, hi) slab of A's DIA data, b and x0 can be produced
# without touching the rest (the reference instead uploads shards sliced from
# one host-resident global system, ``ConjugateGradientParallelGpu.cs:358-379``,
# which caps it at host memory).
# ---------------------------------------------------------------------------


def b_rows(kind: str, lo: int, hi: int, n: int, dtype=np.float64, seed: int = 0) -> np.ndarray:
    """RHS recipe values for rows [lo, hi) (kinds as in ``banded_sin_system``
    plus ``poisson`` = the smooth Poisson-workload RHS)."""
    i = np.arange(lo, hi, dtype=dtype)
    if kind == "cos10":
        return 10.0 * np.cos(i)
    if kind == "one_plus":
        return 1.0 + 0.1 * i
    if kind == "asin":
        return np.arcsin(i / n)
    if kind == "i2/2":
        return 0.5 * i * i
    if kind == "poisson":
        return (np.sin(0.37 * i + seed) + 0.25 * np.cos(1.3 * i)).astype(dtype)
    raise ValueError(f"unknown b kind {kind!r}")


def x0_rows(kind: str, lo: int, hi: int, dtype=np.float64) -> np.ndarray:
    i = np.arange(lo, hi, dtype=dtype)
    if kind == "i/100":
        return i / 100.0
    if kind == "i/10":
        return i / 10.0
    if kind == "zeros":
        return np.zeros(hi - lo, dtype=dtype)
    raise ValueError(f"unknown x0 kind {kind!r}")


def system_rows(
    builder: str,
    lo: int,
    hi: int,
    n: int,
    band: int = 0,
    grid=None,
    b_kind: str = "cos10",
    x0_kind: str = "zeros",
    dtype=np.float64,
    param: float | None = None,
):
    """(offsets, A-data columns, b, x0) for rows [lo, hi) of a named workload
    family: the block callback behind ``parallel.multihost
    .make_distributed_system``.  ``param``: the family's scalar knob —
    the Helmholtz shift (default 0.05) or the convection-diffusion eps
    (default 0.05)."""
    if builder == "banded_sin":
        offsets, data = banded_sin_rows(n, band, lo, hi, dtype=dtype)
    elif builder == "tridiagonal":
        offsets, data = tridiagonal_rows(n, lo, hi, dtype=dtype)
        b_kind = "i2/2"
    elif builder == "poisson":
        g = tuple(grid)
        if len(g) == 1:
            offsets, data = tridiagonal_rows(g[0], lo, hi, diag=2.0, off=-1.0, dtype=dtype)
        elif len(g) == 2:
            offsets, data = poisson2d_rows(g[1], g[0], lo, hi, dtype=dtype)
        elif len(g) == 3:
            offsets, data = poisson3d_rows(g[2], g[1], g[0], lo, hi, dtype=dtype)
        else:
            raise ValueError("poisson grid must be 1-3D")
        b_kind = "poisson"
        x0_kind = "zeros"
    elif builder == "helmholtz":
        offsets, data = helmholtz_rows(
            tuple(grid), 0.05 if param is None else param, lo, hi, dtype=dtype
        )
        b_kind = "poisson"
        x0_kind = "zeros"
    elif builder == "convection_diffusion":
        rows_fn = (
            convection_diffusion_rows
            if len(tuple(grid)) == 2
            else convection_diffusion3d_rows
        )
        offsets, data = rows_fn(
            tuple(grid), lo, hi, eps=0.05 if param is None else param, dtype=dtype
        )
        b_kind = "poisson"
        x0_kind = "zeros"
    else:
        raise ValueError(f"unknown builder {builder!r}")
    return (
        offsets,
        data,
        b_rows(b_kind, lo, hi, n, dtype=dtype),
        x0_rows(x0_kind, lo, hi, dtype=dtype),
    )
