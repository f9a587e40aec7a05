"""Stencil kernels: CUDA wrappers and their plain PyTorch twins.

Two kernels of ``csrc/stencil.cu`` and one of ``csrc/stencil_var.cu``
(design notes at the top of each file):

- ``spmv_const_stencil_cuda`` — y = A x for a 1-D, 2-D or 3-D
  ``ConstStencilMatrix`` in fp32 or fp64 (kernel #1, replaces
  ``conjugategradient_tpu/ops/pallas_stencil.py::_kernel``), on the 3-D view
  of ``const_view`` with the launch of ``const_geometry``;
- ``cheb_smooth_const_cuda`` — the whole degree-d Chebyshev recurrence on
  D⁻¹A for a 3-D const stencil, optionally from a zero x0 and optionally
  emitting r = D⁻¹(b − A x_out) (replaces ``_cheb_kernel``);
- ``spmv_stencil_cuda`` — y = A x for a variable-coefficient
  ``StencilMatrix`` (kernel #3, replaces ``_kernel_var``), in three
  instantiations by (leg dtype, vector dtype): (fp32, fp32), (bf16, fp32)
  with the legs upcast in registers, and (fp64, fp64).  Two kernels, chosen
  by ``var_route``: the tuned ``spmv_var_kernel`` for halo-1 stencils of up
  to 27 legs on 2-D and 3-D grids, and ``spmv_var_wide_kernel``
  (``spmv_stencil_wide_cuda``) for the wider Galerkin levels of the
  hybrid, semicoarsening and aggregation transfers: |shift| <= 7, up to
  3375 legs, 1-D to 3-D, its legs' offsets and shifts in a device table
  (``wide_view``), each point's legs split across ``wide_split`` threads
  where the points alone do not fill the card (``wide_geometry``).

Each wrapper runs its twin (``*_ref``) for a tensor on the CPU, and only
there.  For any other tensor it checks everything the kernel does not take
(device, dtype, rank and shape, contiguity, the shift and leg limits; the
fused smoother takes fp32 3-D grids only), raises on a mismatch, and
launches the kernel on the current CUDA stream; a launch that the runtime
refuses raises too.  ``launches`` on each wrapper counts its kernel launches
and nothing else (``spmv_stencil_cuda`` the tuned kernel's,
``spmv_stencil_wide_cuda`` the wide one's); ``launches_by_grid`` splits the
count by grid, so a run can show that every level went through its kernel,
and ``launches_by_dtype`` (the SpMVs) by state or leg dtype.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import itertools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops import _build

#: Limits of the kernels' by-value argument structs (``csrc/stencil.cu``,
#: ``csrc/stencil_var.cu``); the wide kernel #3's legs and halo
#: (``WIDE_LEGS``, ``WIDE_HALO`` there: every shift of the halo-7 box).
MAX_LEGS = 27
MAX_DEGREE = 5
WIDE_LEGS = 3375
WIDE_HALO = 7


def _cheb_halo(degree: int, zero_x: bool, want_resid: bool) -> int:
    """Deepest chain of operator applications that the outputs consume:
    ``degree``, plus one for the ``A x0`` of a given x0 when the residual is
    emitted (the x path still erodes only ``degree`` deep)."""
    return degree + (1 if (want_resid and not zero_x) else 0)


#: kernel #1's compile-time patterns on its 3-D view (``const_view``), each
#: in the order ``dia_to_stencil`` gives it (``pat_z``/``pat_y``/``pat_x`` in
#: ``csrc/stencil.cu``): the 1-D 3-point, the 2-D 5-point star and 9-point
#: box (a 2-D grid is viewed as (ny, 1, nx)), the 3-D 7-point star and
#: 27-point box.  Any other shift list takes the run-time instantiation, 0.
_TRIPLES = tuple(itertools.product((-1, 0, 1), repeat=3))
CONST_PATTERNS = {
    3: ((0, 0, -1), (0, 0, 0), (0, 0, 1)),
    5: ((-1, 0, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (1, 0, 0)),
    9: tuple(s for s in _TRIPLES if s[1] == 0),
    7: tuple(s for s in _TRIPLES if sum(map(abs, s)) <= 1),
    27: _TRIPLES,
}

class ConstView(NamedTuple):
    """Kernel #1's 3-D view of a grid: ``dims`` (nz, ny, nx) with a 2-D grid
    (ny, nx) as (ny, 1, nx), so its rows are the marched axis, and a 1-D
    grid (n,) as (1, 1, n); ``shifts`` the legs' (dz, dy, dx) on it;
    ``spec`` the instantiation (a key of ``CONST_PATTERNS``, or 0)."""

    dims: Tuple[int, int, int]
    shifts: Tuple[Tuple[int, int, int], ...]
    spec: int


@functools.lru_cache(maxsize=256)
def const_view(grid: Tuple[int, ...], shifts: Tuple[Tuple[int, ...], ...]) -> ConstView:
    """Kernel #1's view of a 1-D, 2-D or 3-D grid and its shifts."""
    if len(grid) == 3:
        dims, sh = tuple(grid), tuple(tuple(s) for s in shifts)
    elif len(grid) == 2:
        dims, sh = (grid[0], 1, grid[1]), tuple((s[0], 0, s[1]) for s in shifts)
    else:
        dims, sh = (1, 1, grid[0]), tuple((0, 0, s[0]) for s in shifts)
    spec = next((p for p, pat in CONST_PATTERNS.items() if pat == sh), 0)
    return ConstView(dims, sh, spec)


class ConstGeometry(NamedTuple):
    """Kernel #1's launch on a view, which the C entry takes as given:
    ``block`` (x, y) threads, one row of them where the view has one row per
    plane (1-D and 2-D grids), else 32 x 8; ``zrun`` the planes a thread
    marches (the library's compile-time run, ``cg_spmv_const_zrun``);
    ``grid`` the blocks along (x, y, z) that cover the view."""

    block: Tuple[int, int]
    zrun: int
    grid: Tuple[int, int, int]


def const_geometry(view: ConstView, zrun: int) -> ConstGeometry:
    """Kernel #1's launch for ``view`` with runs of ``zrun`` planes."""
    nz, ny, nx = view.dims
    block = ((256 if nx > 128 else (128 if nx > 32 else 32)), 1) if ny == 1 else (32, 8)
    return ConstGeometry(block, zrun, (-(-nx // block[0]), -(-ny // block[1]), -(-nz // zrun)))


#: z chunks of kernel #2 (planes one block owns), largest first: a launch
#: takes the largest that still gives every SM a block
CHEB_CHUNKS = (128, 64, 32, 16)
#: the H100 SXM's streaming multiprocessors
H100_SMS = 132


class ChebGeometry(NamedTuple):
    """Kernel #2's launch geometry for one (degree, zero_x, want_resid)
    variant, the same as ``Wave`` in ``csrc/stencil.cu`` (whose C entry
    refuses a halo or tile that differs): ``h`` the halo, ``napps`` the
    applications of A (pipeline stages), ``tile`` the (x, y) interior tile,
    ``threads`` one per column of the tile plus h on each side, ``smem`` the
    bytes of the operand rings (four planes of the extended tile per
    stage), ``chunk`` the z planes a block owns."""

    h: int
    napps: int
    tile: Tuple[int, int]
    threads: int
    smem: int
    chunk: int


def cheb_geometry(degree: int, zero_x: bool, want_resid: bool, grid=None,
                  sms: int = H100_SMS) -> ChebGeometry:
    """Kernel #2's geometry; ``chunk`` for a 3-D ``grid`` on a card with
    ``sms`` multiprocessors (the smallest chunk without a grid)."""
    h = _cheb_halo(degree, zero_x, want_resid)
    napps = (0 if zero_x else 1) + degree - 1 + (1 if want_resid else 0)
    tx, ty = 32, (16 if h <= 4 else 8)
    ext = (tx + 2 * h) * (ty + 2 * h)
    chunk = CHEB_CHUNKS[-1]
    if grid is not None:
        nz, ny, nx = grid
        tiles = -(-nx // tx) * -(-ny // ty)
        chunk = next((c for c in CHEB_CHUNKS if tiles * -(-nz // c) >= sms), chunk)
    return ChebGeometry(h, napps, (tx, ty), ext, napps * 4 * ext * 4, chunk)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _cheb_scalars(degree: int, lam_max: float, lam_min: float):
    """(theta, [rho_{k+1} rho_k], [2 rho_{k+1} / delta]) in Python double
    precision, exactly as ``chebyshev_smooth`` steps them."""
    theta = 0.5 * (lam_max + lam_min)
    delta = 0.5 * (lam_max - lam_min)
    sigma = theta / delta
    rho = 1.0 / sigma
    alphas, betas = [], []
    for _ in range(degree - 1):
        rho_new = 1.0 / (2.0 * sigma - rho)
        alphas.append(rho_new * rho)
        betas.append(2.0 * rho_new / delta)
        rho = rho_new
    return theta, alphas, betas


# ---------------------------------------------------------------------------
# plain PyTorch twins
# ---------------------------------------------------------------------------


def spmv_const_stencil_ref(A: ConstStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x on grid-shaped ``x`` by zero-pad + static slices, legs summed
    in ``A.shifts`` order (the zero padding is the Dirichlet boundary).  A
    leading column axis, ``(k, *grid)``, is carried through: the SpMM."""
    halo = A.halo
    pad = []
    for h in reversed(halo):  # F.pad lists the last axis first
        pad += [h, h]
    xp = F.pad(x, pad)
    y = None
    for c, shift in zip(A.coeffs, A.shifts):
        sl = tuple(slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid))
        term = c * xp[(..., *sl)]
        y = term if y is None else y + term
    return y


def cheb_smooth_const_ref(
    A: ConstStencilMatrix,
    b: torch.Tensor,
    x: Optional[torch.Tensor],
    degree: int,
    lam_max: float,
    lam_min: float,
    inv_diag,
    want_resid: bool = False,
):
    """The fused kernel's schedule on whole arrays: ``chebyshev_smooth`` with
    a zero-x0 variant (``x=None``) that skips ``A x0``, the last r update
    skipped unless ``want_resid``.  Returns ``x_out`` or ``(x_out, r)`` with
    ``r = D⁻¹(b − A x_out)``."""
    invd = torch.as_tensor(inv_diag, dtype=b.dtype, device=b.device)
    theta, alphas, betas = _cheb_scalars(degree, lam_max, lam_min)
    if x is None:
        x = torch.zeros_like(b)
        r = invd * b
    else:
        r = invd * (b - spmv_const_stencil_ref(A, x))
    d = r / theta
    for k in range(degree):
        x = x + d
        last = k == degree - 1
        if not (last and not want_resid):
            r = r - invd * spmv_const_stencil_ref(A, d)
        if not last:
            d = alphas[k] * d + betas[k] * r
    return (x, r) if want_resid else x


def spmv_stencil_ref(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for a variable-coefficient stencil on grid-shaped ``x``: zero
    pad + static slices, legs summed in ``A.shifts`` order, each leg upcast
    to ``x``'s dtype (bf16 legs under fp32 state accumulate in fp32).  A
    leading column axis is carried through, as in ``spmv_const_stencil_ref``."""
    halo = A.halo
    pad = []
    for h in reversed(halo):
        pad += [h, h]
    xp = F.pad(x, pad)
    y = None
    for k, shift in enumerate(A.shifts):
        sl = tuple(slice(h + s, h + s + g) for h, s, g in zip(halo, shift, A.grid))
        term = A.data[k].to(x.dtype) * xp[(..., *sl)]
        y = term if y is None else y + term
    return y


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_dtype(name: str, tensors: Sequence[torch.Tensor], dtypes) -> None:
    for t in tensors:
        if t.dtype not in dtypes:
            names = " or ".join(str(d).replace("torch.", "") for d in dtypes)
            raise TypeError(f"{name}: the kernel takes {names} only, got {t.dtype}")


def _check_kernel_args(name: str, A: ConstStencilMatrix, tensors: Sequence[torch.Tensor]):
    """Raise on anything the kernels do not take but a dtype (each wrapper
    checks its kernel's dtypes)."""
    if not isinstance(A, ConstStencilMatrix):
        raise TypeError(f"{name}: needs a ConstStencilMatrix, got {type(A).__name__}")
    if len(A.grid) not in (1, 2, 3):
        raise ValueError(f"{name}: needs a 1-D, 2-D or 3-D grid, got grid={A.grid}")
    if any(abs(s) > 1 for sh in A.shifts for s in sh):
        raise ValueError(f"{name}: per-axis shifts must be in {{-1, 0, 1}}, got {A.shifts}")
    if not 1 <= A.nlegs <= MAX_LEGS:
        raise ValueError(f"{name}: 1..{MAX_LEGS} legs supported, got {A.nlegs}")
    dev = tensors[0].device
    for t in tensors:
        if tuple(t.shape) != tuple(A.grid):
            raise ValueError(f"{name}: tensor of shape {tuple(t.shape)} is not grid {A.grid}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors only")
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: the kernel needs CUDA tensors on one device, got {t.device}")


def _shifts_arg(shifts, ndim: int):
    """The shifts as a ctypes array of (dz, dy, dx) triples; 2-D shifts
    become (0, dy, dx)."""
    pad = (0,) * (3 - ndim)
    flat = [int(s) for sh in shifts for s in pad + tuple(sh)]
    return (ctypes.c_int * len(flat))(*flat)


def _legs(A: ConstStencilMatrix):
    """(coeffs, shifts) as ctypes arrays."""
    coeffs = (ctypes.c_float * A.nlegs)(*[float(c) for c in A.coeffs])
    return coeffs, _shifts_arg(A.shifts, len(A.grid))


def _raise_on(lib, err: int, name: str):
    if err != 0:
        msg = lib.cg_error_string(err).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({err})")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


@functools.lru_cache(maxsize=256)
def _const_args(coeffs: Tuple[float, ...], view: ConstView):
    """(coeffs as doubles, the view's shifts as triples) as ctypes arrays."""
    flat = [s for sh in view.shifts for s in sh]
    return (ctypes.c_double * len(coeffs))(*coeffs), (ctypes.c_int * len(flat))(*flat)


@functools.lru_cache(maxsize=None)
def _const_zrun(lib, spec: int) -> int:
    """The z run that ``lib`` compiled for pattern ``spec``."""
    return lib.cg_spmv_const_zrun(spec)


def _const_launch(lib, A: ConstStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel #1 of ``lib`` on checked arguments."""
    view = const_view(tuple(A.grid), tuple(A.shifts))
    geo = const_geometry(view, _const_zrun(lib, view.spec))
    y = torch.empty_like(x)
    coeffs, shifts = _const_args(tuple(float(c) for c in A.coeffs), view)
    err = lib.cg_spmv_const(_CODES[(x.dtype, x.dtype)], view.spec, x.data_ptr(), y.data_ptr(),
                            *view.dims, A.nlegs, coeffs, shifts, *geo.block, *geo.grid, _stream(x))
    _raise_on(lib, err, "spmv_const_stencil_cuda")
    return y


def spmv_const_stencil_cuda(A: ConstStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for grid-shaped ``x``: kernel #1 for a CUDA tensor (fp32 or
    fp64, 1-D, 2-D or 3-D), the twin for a CPU tensor."""
    if x.device.type == "cpu":
        return spmv_const_stencil_ref(A, x)
    name = "spmv_const_stencil_cuda"
    _check_dtype(name, [x], (torch.float32, torch.float64))
    _check_kernel_args(name, A, [x])
    y = _const_launch(_build.load("stencil"), A, x)
    spmv_const_stencil_cuda.launches += 1
    spmv_const_stencil_cuda.launches_by_grid[tuple(A.grid)] += 1
    spmv_const_stencil_cuda.launches_by_dtype[TAGS[x.dtype]] += 1
    return y


spmv_const_stencil_cuda.launches = 0
spmv_const_stencil_cuda.launches_by_grid = collections.Counter()
spmv_const_stencil_cuda.launches_by_dtype = collections.Counter()


def _cheb_launch(lib, A, b, x, degree, lam_max, lam_min, invd, want_resid, geo: ChebGeometry):
    """Launch kernel #2 of ``lib`` with geometry ``geo`` on checked
    arguments; returns ``(x_out, r_out or None)``."""
    theta, alphas, betas = _cheb_scalars(degree, lam_max, lam_min)
    nz, ny, nx = A.grid
    x_out = torch.empty_like(b)
    r_out = torch.empty_like(b) if want_resid else None
    coeffs, shifts = _legs(A)
    alpha = (ctypes.c_float * MAX_DEGREE)(*alphas)
    beta = (ctypes.c_float * MAX_DEGREE)(*betas)
    err = lib.cg_cheb_const(
        b.data_ptr(), None if x is None else x.data_ptr(), invd.data_ptr(),
        x_out.data_ptr(), None if r_out is None else r_out.data_ptr(),
        nz, ny, nx, A.nlegs, coeffs, shifts, degree, geo.h, *geo.tile, geo.chunk, theta, alpha,
        beta, _stream(b),
    )
    _raise_on(lib, err, "cheb_smooth_const_cuda")
    return x_out, r_out


def cheb_smooth_const_cuda(
    A: ConstStencilMatrix,
    b: torch.Tensor,
    x: Optional[torch.Tensor],
    degree: int,
    lam_max: float,
    lam_min: float,
    inv_diag,
    want_resid: bool = False,
):
    """One fused degree-``degree`` Chebyshev smoothing of a 3-D const
    stencil (``x=None``: zero initial guess).  ``inv_diag`` is a scalar (a
    const level has a constant diagonal); the kernel reads it from device
    memory, so a 0-d CUDA tensor costs no host sync.  Returns ``x_out`` or
    ``(x_out, r)`` with ``r = D⁻¹(b − A x_out)``."""
    if b.device.type == "cpu":
        return cheb_smooth_const_ref(A, b, x, degree, lam_max, lam_min, inv_diag, want_resid)
    name = "cheb_smooth_const_cuda"
    if len(A.grid) != 3:
        raise ValueError(f"{name}: needs a 3-D grid, got grid={A.grid}")
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"{name}: degree must be in 1..{MAX_DEGREE}, got {degree}")
    tensors = [b] if x is None else [b, x]
    _check_dtype(name, tensors, (torch.float32,))
    _check_kernel_args(name, A, tensors)
    invd = torch.as_tensor(inv_diag, dtype=torch.float32, device=b.device)
    if invd.ndim != 0:
        raise ValueError(f"{name}: inv_diag must be a scalar, got shape {tuple(invd.shape)}")
    x_out, r_out = _cheb_launch(_build.load("stencil"), A, b, x, degree, lam_max, lam_min, invd,
                                want_resid, cheb_geometry(degree, x is None, want_resid, A.grid,
                                                          _sms(b.device.index)))
    cheb_smooth_const_cuda.launches += 1
    cheb_smooth_const_cuda.launches_by_grid[tuple(A.grid)] += 1
    return (x_out, r_out) if want_resid else x_out


cheb_smooth_const_cuda.launches = 0
cheb_smooth_const_cuda.launches_by_grid = collections.Counter()

#: (leg dtype, vector dtype) -> the instantiation code of the C entries
#: that take legs (``cg_spmv_var`` here, the DIA entries of ``csrc/dia.cu``)
_CODES = {
    (torch.float32, torch.float32): 0,
    (torch.bfloat16, torch.float32): 1,
    (torch.float64, torch.float64): 2,
}
#: leg dtype -> the key of ``launches_by_dtype``
TAGS = {torch.float32: "fp32", torch.bfloat16: "bf16", torch.float64: "fp64"}
#: leg counts with an instantiation of their own in kernel #3: the 2-D fine
#: (5) and Galerkin (9) levels, the 3-D fine (7) and Galerkin (27) levels
SPECIALISED_LEGS = (5, 7, 9, 27)


def var_instantiation(nlegs: int) -> int:
    """Kernel #3's instantiation for ``nlegs`` legs: the count itself where
    it has its own, else 0, the generic one that reads the count at run
    time."""
    return nlegs if nlegs in SPECIALISED_LEGS else 0


class WideView(NamedTuple):
    """The wide kernel #3's view of a grid: ``dims`` (nz, ny, nx) with a
    2-D grid (ny, nx) as (ny, 1, nx) and a 1-D grid (n,) as (1, 1, n), so
    rows are the marched axis (the C entry takes it as given); ``shifts``
    the legs' (dz, dy, dx) on it; ``offsets`` each leg's folded flat
    offset dz * ny * nx + dy * nx + dx."""

    dims: Tuple[int, int, int]
    shifts: Tuple[Tuple[int, int, int], ...]
    offsets: Tuple[int, ...]


def wide_view(grid: Tuple[int, ...], shifts: Tuple[Tuple[int, ...], ...]) -> WideView:
    """The wide kernel's view of a 1-D, 2-D or 3-D grid and its shifts."""
    dims = (1,) * (3 - len(grid)) + tuple(grid)
    sh = [(0,) * (3 - len(grid)) + tuple(s) for s in shifts]
    if dims[0] == 1:  # march over rows: (1, ny, nx) -> (ny, 1, nx)
        dims = (dims[1], 1, dims[2])
        sh = [(s[1], s[0], s[2]) for s in sh]
    _, ny, nx = dims
    return WideView(dims, tuple(sh), tuple(z * ny * nx + y * nx + x for z, y, x in sh))


#: the wide kernel's z run (``WIDE_ZRUN`` in ``csrc/stencil_var.cu``), and
#: the threads a card must get before a launch takes it: below that the
#: runs do not fill the card and each thread takes one plane
WIDE_ZRUN = 4
WIDE_FILL_THREADS_PER_SM = 2048
#: threads of an unsplit wide block, and of a split one (``WIDE_THREADS``,
#: ``WIDE_MAX_THREADS``)
WIDE_THREADS = 256
WIDE_MAX_THREADS = 1024
#: the threads of a split launch an SM holds at once (its 1024-thread
#: blocks cap a thread at 64 registers, 65,536 an SM), and the fewest legs
#: a slice keeps (loads in flight per thread)
WIDE_SPLIT_THREADS_PER_SM = 1024
WIDE_MIN_SLICE = 16


def wide_zrun(view: WideView, sms: int = H100_SMS) -> int:
    """The planes a thread of the wide kernel marches on ``view``:
    ``WIDE_ZRUN`` where that still gives a full card of threads (every SM
    ``WIDE_FILL_THREADS_PER_SM``) or where one plane a block would exceed
    the launch's 65,535 blocks along z, else 1."""
    nz, ny, nx = view.dims
    runs = nx * ny * -(-nz // WIDE_ZRUN)
    return WIDE_ZRUN if runs >= sms * WIDE_FILL_THREADS_PER_SM or nz > 65535 else 1


def _wide_lanes(view: WideView) -> int:
    """x lanes of a wide block: one row of threads (256, 128 or 32 wide) on
    a view with one row per plane (1-D and 2-D grids), else 32, or 16 on
    rows of at most 16."""
    nz, ny, nx = view.dims
    if ny == 1:
        return 256 if nx > 128 else (128 if nx > 32 else 32)
    return 32 if nx > 16 else 16


def wide_split(view: WideView, nlegs: int, sms: int = H100_SMS) -> int:
    """S, the slices of the leg list the wide kernel splits each point's
    sum into on ``view``: 1 where ``wide_zrun``'s runs fill the card;
    otherwise the largest power of two whose S threads a point still run in
    one wave (every SM ``WIDE_SPLIT_THREADS_PER_SM``), as long as each
    slice keeps ``WIDE_MIN_SLICE`` legs and a block of one row of points
    holds S.  Measured on the H100 (PERF.md): at 32^3 x 343 and 16^3 x
    1331 the largest split that fits one wave beat twice as many threads
    with half the legs each."""
    if wide_zrun(view, sms) != 1:
        return 1
    points = view.dims[0] * view.dims[1] * view.dims[2]
    most = WIDE_MAX_THREADS // _wide_lanes(view)
    split = 1
    while (points * 2 * split <= sms * WIDE_SPLIT_THREADS_PER_SM
           and 2 * split * WIDE_MIN_SLICE <= nlegs and 2 * split <= most):
        split *= 2
    return split


class WideGeometry(NamedTuple):
    """The wide kernel #3's launch on a view, which the C entry takes as
    given (it refuses one that does not cover the view exactly): ``block``
    the (x lanes, rows) of points a block holds, ``split`` the slices of
    the leg list (the block's threads are lanes x rows x split),
    ``zrun`` the planes a thread marches, ``grid`` the blocks along (x, y,
    z)."""

    block: Tuple[int, int]
    split: int
    zrun: int
    grid: Tuple[int, int, int]


def wide_geometry(view: WideView, nlegs: int, sms: int = H100_SMS,
                  split: Optional[int] = None) -> WideGeometry:
    """The wide kernel's launch for ``nlegs`` legs on ``view``: ``split``
    by ``wide_split`` unless given (a given split > 1 takes one plane a
    thread), the z run by ``wide_zrun``, and as many rows of points a block
    as keep it within ``WIDE_THREADS`` (``WIDE_MAX_THREADS`` when split)."""
    if split is None:
        split = wide_split(view, nlegs, sms)
    zrun = wide_zrun(view, sms) if split == 1 else 1
    if not 1 <= split <= nlegs:
        raise ValueError(f"wide kernel #3: split must be in 1..{nlegs} (the legs), got {split}")
    nz, ny, nx = view.dims
    lanes = _wide_lanes(view)
    cap = WIDE_THREADS if split == 1 else WIDE_MAX_THREADS
    if lanes * split > cap:
        raise ValueError(f"wide kernel #3: at most {cap // lanes} slices on rows of {lanes} "
                         f"lanes, got {split}")
    rows = 1 if ny == 1 else max(1, min(WIDE_THREADS, cap // split) // lanes)
    return WideGeometry((lanes, rows), split, zrun,
                        (-(-nx // lanes), -(-ny // rows), -(-nz // zrun)))


def wide_slices(nlegs: int, split: int) -> Tuple[Tuple[int, int], ...]:
    """The legs [lo, hi) of each slice, in order: ``s * nlegs // split`` to
    ``(s + 1) * nlegs // split``, as the kernel computes them."""
    return tuple((s * nlegs // split, (s + 1) * nlegs // split) for s in range(split))


def _wide_table(view: WideView, device: torch.device) -> torch.Tensor:
    """``view``'s leg table on ``device``, one int2 a leg: the folded
    offset, and (sz, sy, sx) as signed bytes 0-2 of the second int."""
    rows = [(off, (z & 0xFF) | ((y & 0xFF) << 8) | ((x & 0xFF) << 16))
            for off, (z, y, x) in zip(view.offsets, view.shifts)]
    return torch.tensor(rows, dtype=torch.int32, device=device)


#: facts of a leg list cached by the identity of its shifts tuple (a level
#: rebuilds its StencilMatrix over the same tuple on every access): scanning
#: or hashing a 1331-leg list at every launch kept the host longer than the
#: kernel takes
_BY_SHIFTS: dict = {}


def _by_shifts(shifts, key, make):
    """``make()``, cached under ``key`` for the tuple ``shifts`` (held, so
    its id is not reused while cached)."""
    k = (id(shifts), key)
    hit = _BY_SHIFTS.get(k)
    if hit is None or hit[0] is not shifts:
        if len(_BY_SHIFTS) >= 512:
            _BY_SHIFTS.clear()
        hit = _BY_SHIFTS[k] = (shifts, make())
    return hit[1]


def var_route(A: StencilMatrix) -> str:
    """Which kernel #3 takes ``A`` on the card: ``"narrow"`` (the tuned
    halo-1 kernel) for every per-axis |shift| <= 1, at most ``MAX_LEGS``
    legs and a 2-D or 3-D grid; otherwise ``"wide"`` within |shift| <=
    ``WIDE_HALO``, 1..``WIDE_LEGS`` legs and a 1-D, 2-D or 3-D grid; beyond
    that ``ValueError``."""
    halo = _by_shifts(A.shifts, "halo",
                      lambda: max((abs(s) for sh in A.shifts for s in sh), default=0))
    if len(A.grid) in (2, 3) and halo <= 1 and 1 <= A.nlegs <= MAX_LEGS:
        return "narrow"
    if len(A.grid) not in (1, 2, 3):
        raise ValueError(f"kernel #3 needs a 1-D, 2-D or 3-D grid, got grid={A.grid}")
    if halo > WIDE_HALO:
        raise ValueError(f"kernel #3: per-axis shifts must be in [-{WIDE_HALO}, {WIDE_HALO}], "
                         f"got {A.shifts}")
    if not 1 <= A.nlegs <= WIDE_LEGS:
        raise ValueError(f"kernel #3: 1..{WIDE_LEGS} legs supported, got {A.nlegs}")
    return "wide"


def _check_var_args(name: str, A: StencilMatrix, x: torch.Tensor) -> int:
    """Raise on anything kernel #3 (tuned or wide) does not take; return
    the instantiation code."""
    if not isinstance(A, StencilMatrix):
        raise TypeError(f"{name}: needs a StencilMatrix, got {type(A).__name__}")
    legs = A.data
    if not torch.is_tensor(legs):
        raise TypeError(f"{name}: A.data must be a torch tensor (use StencilMatrix.device_put)")
    var_route(A)
    if tuple(legs.shape) != (A.nlegs,) + tuple(A.grid):
        raise ValueError(f"{name}: legs of shape {tuple(legs.shape)} are not (nlegs, *grid)")
    code = _CODES.get((legs.dtype, x.dtype))
    if code is None:
        raise TypeError(
            f"{name}: no kernel for {legs.dtype} legs with a {x.dtype} vector; "
            f"supported: {[(str(d), str(v)) for d, v in _CODES]}"
        )
    if tuple(x.shape) != tuple(A.grid):
        raise ValueError(f"{name}: tensor of shape {tuple(x.shape)} is not grid {A.grid}")
    if not (legs.is_contiguous() and x.is_contiguous()):
        raise ValueError(f"{name}: the kernel takes contiguous tensors only")
    for t in (legs, x):
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"{name}: the kernel needs CUDA tensors on one device, got {t.device}")
    return code


def _var_launch(lib, code: int, A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch kernel #3 of ``lib`` on checked arguments."""
    nz, ny, nx = ((1,) * (3 - len(A.grid))) + tuple(A.grid)
    y = torch.empty_like(x)
    err = lib.cg_spmv_var(code, var_instantiation(A.nlegs), A.data.data_ptr(), x.data_ptr(),
                          y.data_ptr(), nz, ny, nx, A.nlegs, _shifts_arg(A.shifts, len(A.grid)),
                          _stream(x))
    _raise_on(lib, err, "spmv_stencil_cuda")
    return y


def _count(fn, A: StencilMatrix) -> None:
    fn.launches += 1
    fn.launches_by_grid[tuple(A.grid)] += 1
    fn.launches_by_dtype[TAGS[A.data.dtype]] += 1


def spmv_stencil_cuda(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for grid-shaped ``x`` and a device ``StencilMatrix``: the twin
    for a CPU tensor; for a CUDA tensor kernel #3 by ``var_route``: the
    tuned kernel (counted here) for every per-axis |shift| <= 1, at most 27
    legs and a 2-D or 3-D grid; else the wide kernel
    (``spmv_stencil_wide_cuda``, counted there) for |shift| <= 7, 1 to 3375
    legs and a 1-D, 2-D or 3-D grid; beyond that ``ValueError``."""
    if x.device.type == "cpu":
        return spmv_stencil_ref(A, x)
    name = "spmv_stencil_cuda"
    code = _check_var_args(name, A, x)
    if var_route(A) == "wide":
        return _wide(code, A, x)
    y = _var_launch(_build.load("stencil_var"), code, A, x)
    _count(spmv_stencil_cuda, A)
    return y


def _wide_plan(A: StencilMatrix, device: torch.device):
    """(view, table on ``device``, the default launch) of ``A``, cached by
    its shifts tuple."""
    def plan():
        view = wide_view(tuple(A.grid), tuple(A.shifts))
        return view, _wide_table(view, device), wide_geometry(view, A.nlegs, _sms(device.index))

    return _by_shifts(A.shifts, (tuple(A.grid), device), plan)


def _wide_launch(lib, code: int, A: StencilMatrix, x: torch.Tensor, view: WideView,
                 table: torch.Tensor, geo: WideGeometry) -> torch.Tensor:
    """Launch the wide kernel #3 of ``lib`` with ``geo`` on checked
    arguments."""
    y = torch.empty_like(x)
    err = lib.cg_spmv_var_wide(code, A.data.data_ptr(), x.data_ptr(), y.data_ptr(),
                               table.data_ptr(), A.nlegs, *view.dims, *geo.block, geo.split,
                               geo.zrun, *geo.grid, _stream(x))
    _raise_on(lib, err, "spmv_stencil_wide_cuda")
    return y


def _wide(code: int, A: StencilMatrix, x: torch.Tensor):
    """The wide kernel #3 on checked arguments, counted."""
    y = _wide_launch(_build.load("stencil_var"), code, A, x, *_wide_plan(A, x.device))
    _count(spmv_stencil_wide_cuda, A)
    return y


def spmv_stencil_wide_cuda(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x by the wide kernel #3 for any stencil within its limits
    (|shift| <= 7, 1 to 3375 legs, 1-D to 3-D), the tuned kernel's shapes
    too: the twin for a CPU tensor.  ``spmv_stencil_cuda`` routes here where
    the tuned kernel does not reach."""
    if x.device.type == "cpu":
        return spmv_stencil_ref(A, x)
    return _wide(_check_var_args("spmv_stencil_wide_cuda", A, x), A, x)


for _fn in (spmv_stencil_cuda, spmv_stencil_wide_cuda):
    _fn.launches = 0
    _fn.launches_by_grid = collections.Counter()
    _fn.launches_by_dtype = collections.Counter()


def reset_launch_counts() -> None:
    """Set every stencil kernel's launch count to 0."""
    for fn in (spmv_const_stencil_cuda, cheb_smooth_const_cuda, spmv_stencil_cuda,
               spmv_stencil_wide_cuda):
        fn.launches = 0
        fn.launches_by_grid.clear()
    for fn in (spmv_const_stencil_cuda, spmv_stencil_cuda, spmv_stencil_wide_cuda):
        fn.launches_by_dtype.clear()
