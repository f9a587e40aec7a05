"""Stencil kernels: CUDA wrappers and their plain PyTorch twins.

Two kernels of ``csrc/stencil.cu`` and one of ``csrc/stencil_var.cu``
(design notes at the top of each file):

- ``spmv_const_stencil_cuda`` — y = A x for a 2-D/3-D ``ConstStencilMatrix``
  (replaces ``conjugategradient_tpu/ops/pallas_stencil.py::_kernel``);
- ``cheb_smooth_const_cuda`` — the whole degree-d Chebyshev recurrence on
  D⁻¹A for a 3-D const stencil, optionally from a zero x0 and optionally
  emitting r = D⁻¹(b − A x_out) (replaces ``_cheb_kernel``);
- ``spmv_stencil_cuda`` — y = A x for a 2-D/3-D variable-coefficient
  ``StencilMatrix`` with up to 27 legs (kernel #3, replaces
  ``_kernel_var``), in three instantiations by (leg dtype, vector dtype):
  (fp32, fp32), (bf16, fp32) with the legs upcast in registers, and
  (fp64, fp64).

Each wrapper runs its twin (``*_ref``) for a tensor on the CPU, and only
there.  For any other tensor it checks everything the kernel does not take
(device, dtype, rank and shape, contiguity, |shift| > 1, 1-D grids, the leg
limit), raises on a mismatch, and launches the kernel on the current CUDA
stream; a launch that the runtime refuses raises too.  ``launches`` on each
wrapper counts its kernel launches and nothing else; ``launches_by_grid``
(the fused smoother and the variable SpMV) splits the count by grid, so a
run can show that every level went through its kernel, and
``spmv_stencil_cuda.launches_by_dtype`` by leg dtype.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops import _build

#: Limits of the kernels' by-value argument structs (``csrc/stencil.cu``,
#: ``csrc/stencil_var.cu``).
MAX_LEGS = 27
MAX_DEGREE = 5


def _cheb_halo(degree: int, zero_x: bool, want_resid: bool) -> int:
    """Deepest chain of operator applications that the outputs consume:
    ``degree``, plus one for the ``A x0`` of a given x0 when the residual is
    emitted (the x path still erodes only ``degree`` deep)."""
    return degree + (1 if (want_resid and not zero_x) else 0)


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


def _check_kernel_args(name: str, A: ConstStencilMatrix, tensors: Sequence[torch.Tensor]):
    """Raise on anything the kernels do not take."""
    if not isinstance(A, ConstStencilMatrix):
        raise TypeError(f"{name}: needs a ConstStencilMatrix, got {type(A).__name__}")
    if len(A.grid) not in (2, 3):
        raise ValueError(f"{name}: needs a 2-D or 3-D grid, got grid={A.grid}")
    if any(abs(s) > 1 for sh in A.shifts for s in sh):
        raise ValueError(f"{name}: per-axis shifts must be in {{-1, 0, 1}}, got {A.shifts}")
    if not 1 <= A.nlegs <= MAX_LEGS:
        raise ValueError(f"{name}: 1..{MAX_LEGS} legs supported, got {A.nlegs}")
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 only, got {t.dtype}")
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


def spmv_const_stencil_cuda(A: ConstStencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for grid-shaped ``x``: the CUDA kernel for a CUDA tensor, the
    twin for a CPU tensor."""
    if x.device.type == "cpu":
        return spmv_const_stencil_ref(A, x)
    _check_kernel_args("spmv_const_stencil_cuda", A, [x])
    nz, ny, nx = ((1,) * (3 - len(A.grid))) + tuple(A.grid)
    y = torch.empty_like(x)
    coeffs, shifts = _legs(A)
    lib = _build.load("stencil")
    err = lib.cg_spmv_const(
        x.data_ptr(), y.data_ptr(), nz, ny, nx, A.nlegs, coeffs, shifts, _stream(x)
    )
    _raise_on(lib, err, "spmv_const_stencil_cuda")
    spmv_const_stencil_cuda.launches += 1
    return y


spmv_const_stencil_cuda.launches = 0


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
    _check_kernel_args(name, A, [b] if x is None else [b, x])
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


def _check_var_args(name: str, A: StencilMatrix, x: torch.Tensor) -> int:
    """Raise on anything kernel #3 does not take; return the instantiation
    code."""
    if not isinstance(A, StencilMatrix):
        raise TypeError(f"{name}: needs a StencilMatrix, got {type(A).__name__}")
    legs = A.data
    if not torch.is_tensor(legs):
        raise TypeError(f"{name}: A.data must be a torch tensor (use StencilMatrix.device_put)")
    if len(A.grid) not in (2, 3):
        raise ValueError(f"{name}: needs a 2-D or 3-D grid, got grid={A.grid}")
    if any(abs(s) > 1 for sh in A.shifts for s in sh):
        raise ValueError(f"{name}: per-axis shifts must be in {{-1, 0, 1}}, got {A.shifts}")
    if not 1 <= A.nlegs <= MAX_LEGS:
        raise ValueError(f"{name}: 1..{MAX_LEGS} legs supported, got {A.nlegs}")
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


def spmv_stencil_cuda(A: StencilMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x for grid-shaped ``x`` and a device ``StencilMatrix``: kernel
    #3 for a CUDA tensor, the twin for a CPU tensor."""
    if x.device.type == "cpu":
        return spmv_stencil_ref(A, x)
    name = "spmv_stencil_cuda"
    code = _check_var_args(name, A, x)
    y = _var_launch(_build.load("stencil_var"), code, A, x)
    spmv_stencil_cuda.launches += 1
    spmv_stencil_cuda.launches_by_grid[tuple(A.grid)] += 1
    spmv_stencil_cuda.launches_by_dtype[TAGS[A.data.dtype]] += 1
    return y


spmv_stencil_cuda.launches = 0
spmv_stencil_cuda.launches_by_grid = collections.Counter()
spmv_stencil_cuda.launches_by_dtype = collections.Counter()


def reset_launch_counts() -> None:
    """Set every stencil kernel's launch count to 0."""
    for fn in (spmv_const_stencil_cuda, cheb_smooth_const_cuda, spmv_stencil_cuda):
        fn.launches = 0
    cheb_smooth_const_cuda.launches_by_grid.clear()
    spmv_stencil_cuda.launches_by_grid.clear()
    spmv_stencil_cuda.launches_by_dtype.clear()
