"""The schedules of kernel #1 (const-stencil SpMV) and kernel #5 (DIA SpMM),
emulated block by block on the CPU.

``csrc/stencil.cu::spmv_const_kernel`` and ``csrc/dia.cu::spmm_dia_kernel``
run only on the card.  ``const_schedule`` and ``spmm_schedule`` below replay
their launch in torch, one block at a time, with the kernels' own decisions:

- kernel #1 runs on ``const_view``'s 3-D view of the grid with
  ``const_geometry``'s launch, its z run that of the C source (``zrun_of``:
  ``CONST_ZRUN``, one plane for the 1-D pattern); a block whose neighbourhood lies
  inside the grid (the kernel's ``interior`` test) reads without a mask, a
  compile-time pattern reads each value its run needs once (the ``need``
  set, a copy of the kernel's closed form, checked here against the
  patterns) and the run-time pattern reads leg by leg;
- kernel #5 runs blocks of rows, an interior block (every neighbour of
  every row inside [0, n)) without a mask, and the legs in batches, X read
  from memory or from the block's window staged in shared memory.

x (or X) lies between NaNs, so a read that the interior test should have
masked, a wrong row seam or a ragged edge shows as a NaN or an O(1) error.
Each emulation performs the twin's operations in the twin's order, so the
two agree to fp64 rounding: 1e-12 of the largest |twin| entry.
"""

import math
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, DiaMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_ref
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    CONST_PATTERNS,
    const_geometry,
    const_view,
    spmv_const_stencil_ref,
)

#: the emulations repeat the twins' fp64 operations in the same order
REL = 1e-12
#: kernel #1's z run as the library compiles it by default
_SRC = Path(cuda_stencil.__file__).parents[1] / "csrc" / "stencil.cu"
ZRUN = int(re.search(r"#define CONST_ZRUN (\d+)", _SRC.read_text()).group(1))


def zrun_of(spec, zrun=ZRUN):
    """``zrun_of<P>`` of ``csrc/stencil.cu``: the 1-D pattern runs one plane."""
    return 1 if spec == 3 else zrun


def need(spec, zrun, dq, dy, dx):
    """``need<P, ZR>`` of ``csrc/stencil.cu``, its closed form copied."""
    run, ends = 0 <= dq < zrun, -1 <= dq <= zrun
    if spec == 27:
        return ends
    if spec == 9:
        return dy == 0 and ends
    if spec == 3:
        return dy == 0 and run
    if dy == 0 and dx == 0:
        return ends
    if spec == 5:
        return dy == 0 and run
    return (dy == 0 or dx == 0) and run


def const_schedule(A, x, zrun=ZRUN):
    """Kernel #1's launch on CPU tensors, built with ``CONST_ZRUN=zrun``:
    returns y and how often each point was written."""
    view = const_view(A.grid, A.shifts)
    geo = const_geometry(view, zrun_of(view.spec, zrun))
    nz, ny, nx = view.dims
    (bx, by), zr = geo.block, geo.zrun
    plane = ny * nx
    pad = (zr + 2) * plane + nx + 1
    nan = torch.full((pad,), float("nan"), dtype=x.dtype)
    xp = torch.cat([nan, x.reshape(-1), nan])
    y = torch.full((x.numel(),), float("nan"), dtype=x.dtype)
    writes = torch.zeros(x.numel(), dtype=torch.int64)
    hz, hy, hx = (int(any(s[a] != 0 for s in view.shifts)) for a in range(3))
    for gz, gy, gx in np.ndindex(geo.grid[2], geo.grid[1], geo.grid[0]):
        bx0, by0, z0 = gx * bx, gy * by, gz * zr
        interior = (bx0 >= hx and bx0 + bx <= nx - hx and by0 >= hy and by0 + by <= ny - hy
                    and z0 >= hz and z0 + zr <= nz - hz)
        iy, ix = torch.meshgrid(by0 + torch.arange(by), bx0 + torch.arange(bx), indexing="ij")
        keep = (ix < nx) & (iy < ny)  # threads past the grid return at once
        iy, ix = iy[keep], ix[keep]
        p0 = (z0 * ny + iy) * nx + ix

        def load(dq, dy, dx, masked):
            v = xp[p0 + dq * plane + dy * nx + dx + pad]
            if not masked:
                return v
            inside = ((0 <= z0 + dq < nz) & (iy + dy >= 0) & (iy + dy < ny)
                      & (ix + dx >= 0) & (ix + dx < nx))
            return torch.where(inside, v, torch.zeros_like(v))

        if view.spec:
            v = {(q, a, b): load(q, a, b, not interior)
                 for q in range(-1, zr + 1) for a in (-1, 0, 1) for b in (-1, 0, 1)
                 if need(view.spec, zr, q, a, b)}
            for j in range(zr):
                if z0 + j < nz:
                    acc = torch.zeros_like(p0, dtype=x.dtype)
                    for c, (sz, sy, sx) in zip(A.coeffs, view.shifts):
                        acc = acc + c * v[(j + sz, sy, sx)]
                    y[p0 + j * plane] = acc
                    writes[p0 + j * plane] += 1
        else:
            for j in range(min(zr, nz - z0)):
                acc = torch.zeros_like(p0, dtype=x.dtype)
                for c, (sz, sy, sx) in zip(A.coeffs, view.shifts):
                    acc = acc + c * load(j + sz, sy, sx, not interior)
                y[p0 + j * plane] = acc
                writes[p0 + j * plane] += 1
    return y.reshape(A.grid), writes.reshape(A.grid)


_T = tuple(tuple(s) for s in CONST_PATTERNS[27])
STAR7 = CONST_PATTERNS[7]
#: (pattern legs on the grid's own axes, grid): every compile-time pattern,
#: the legs reversed and a short list (the run-time pattern), on grids with
#: interior blocks and ragged edges in every axis, nz = 1, and 1-D
CASES = {
    "3-point (300,)": (((-1,), (0,), (1,)), (300,)),
    "3-point (1000,)": (((-1,), (0,), (1,)), (1000,)),
    "3-point (5,)": (((-1,), (0,), (1,)), (5,)),
    "5-point (21, 300)": (((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), (21, 300)),
    "5-point (3, 40)": (((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), (3, 40)),
    "9-point (21, 300)": (tuple(s[1:] for s in _T if s[0] == 0), (21, 300)),
    "7-point (13, 20, 70)": (STAR7, (13, 20, 70)),
    "7-point (9, 17, 33)": (STAR7, (9, 17, 33)),
    "7-point nz=1 (1, 17, 65)": (STAR7, (1, 17, 65)),
    "27-point (13, 20, 70)": (_T, (13, 20, 70)),
    "27-point nz=1 (1, 17, 65)": (_T, (1, 17, 65)),
    "7-point reversed (13, 20, 70)": (STAR7[::-1], (13, 20, 70)),
    "5-point reversed (21, 300)": (((1, 0), (0, 1), (0, 0), (0, -1), (-1, 0)), (21, 300)),
    "2 legs (300,)": (((0,), (1,)), (300,)),
    "13 legs (13, 20, 70)": (_T[:13], (13, 20, 70)),
}


def _case(name, seed=0):
    shifts, grid = CASES[name]
    rng = np.random.default_rng(seed)
    A = ConstStencilMatrix(tuple(float(c) for c in rng.uniform(-1, 1, len(shifts))), shifts, grid)
    return A, torch.from_numpy(rng.standard_normal(grid))


@pytest.mark.parametrize("zrun", [ZRUN, 1, 2, 8])
@pytest.mark.parametrize("name", sorted(CASES))
def test_const_schedule_matches_twin(name, zrun):
    A, x = _case(name)
    y, writes = const_schedule(A, x, zrun)
    ref = spmv_const_stencil_ref(A, x)
    assert torch.equal(writes, torch.ones_like(writes))  # blocks and runs cover the grid once
    assert not bool(torch.isnan(y).any())  # nothing outside the grid was read
    assert float((y - ref).abs().max()) <= REL * float(ref.abs().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_const_pattern_choice(name):
    shifts, grid = CASES[name]
    spec = const_view(grid, shifts).spec
    if "reversed" in name or "legs" in name:
        assert spec == 0
    else:
        assert spec == int(name.split("-")[0])
        assert spec == len(shifts)


@pytest.mark.parametrize("spec", sorted(CONST_PATTERNS))
@pytest.mark.parametrize("zrun", [1, 2, 4, 8])
def test_need_closed_form_is_the_patterns_reads(spec, zrun):
    # the kernel's closed form reads exactly the values the pattern's legs
    # take over a run: no value twice, none missing
    if spec == 3 and zrun != 1:
        zrun = 1  # the 1-D pattern's run is one plane
    pat = CONST_PATTERNS[spec]
    reads = {(j + sz, sy, sx) for j in range(zrun) for sz, sy, sx in pat}
    closed = {(q, a, b) for q in range(-1, zrun + 1) for a in (-1, 0, 1) for b in (-1, 0, 1)
              if need(spec, zrun, q, a, b)}
    assert closed == reads


def test_const_views_and_geometry():
    star2 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    v = const_view((1023, 1023), star2)
    assert v.dims == (1023, 1, 1023) and v.spec == 5
    assert v.shifts == CONST_PATTERNS[5]
    assert ZRUN == 4
    g = const_geometry(v, zrun_of(v.spec))
    assert g.block == (256, 1) and g.zrun == 4 and g.grid == (4, 1, 256)
    v1 = const_view((4095,), ((-1,), (0,), (1,)))
    assert v1.dims == (1, 1, 4095) and v1.spec == 3
    assert const_geometry(v1, zrun_of(v1.spec)) == ((256, 1), 1, (16, 1, 1))
    v3 = const_view((255,) * 3, STAR7)
    assert v3.spec == 7 and const_geometry(v3, zrun_of(v3.spec)) == ((32, 8), 4, (8, 32, 64))
    assert const_geometry(const_view((5, 3, 20), STAR7), 4).block == (32, 8)
    assert const_geometry(const_view((7, 40), star2), 4).block == (128, 1)
    assert const_geometry(const_view((7, 20), star2), 4).block == (32, 1)


def test_const_patterns_are_dia_to_stencil_order():
    # the hierarchies' const levels hit the compile-time patterns
    from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
    from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy

    for grid, spec in (((9,), 3), ((9, 11), 5), ((9, 11, 13), 7)):
        A = stencil_to_const(dia_to_stencil(generators.poisson_system(grid).A, grid))
        assert const_view(A.grid, A.shifts).spec == spec
    h = build_hierarchy(generators.poisson_system((31, 31, 31)).A, (31, 31, 31), device="cpu")
    assert [const_view(l.grid, l.A.shifts).spec for l in h.levels] == [7, 27]
    h = build_hierarchy(generators.poisson_system((127, 127)).A, (127, 127), device="cpu")
    assert [const_view(l.grid, l.A.shifts).spec for l in h.levels] == [5, 9]


def spmm_schedule(A, X, threads, batch, stage):
    """Kernel #5's launch on CPU tensors: blocks of ``threads`` rows, legs in
    batches of ``batch``, X read from the block's staged window (``stage``)
    or from memory; returns Y and how often each row was written."""
    n, k = A.n, X.shape[0]
    offs = tuple(A.offsets)
    lo, hi = min(0, min(offs)), max(0, max(offs))
    pad = max(abs(o) for o in offs) + 1
    nan = torch.full((k, pad), float("nan"), dtype=X.dtype)
    Xp = torch.cat([nan, X, nan], dim=1)
    Y = torch.full((k, n), float("nan"), dtype=X.dtype)
    writes = torch.zeros(n, dtype=torch.int64)
    for i0 in range(0, n, threads):
        rows = torch.arange(i0, min(i0 + threads, n))
        interior = i0 + lo >= 0 and i0 + threads + hi <= n
        acc = torch.zeros((k, rows.numel()), dtype=X.dtype)
        if stage:  # the window X[:, i0 + lo .. i0 + threads + hi), 0 outside [0, n)
            jw = i0 + lo + torch.arange(threads + hi - lo)
            win = torch.where((jw >= 0) & (jw < n), Xp[:, (jw + pad).clamp(0, Xp.shape[1] - 1)], 0.0)
        for k0 in range(0, len(offs), batch):
            coefs = [A.data[kk, rows] for kk in range(k0, min(k0 + batch, len(offs)))]
            for d, off in zip(coefs, offs[k0 : k0 + batch]):
                j = rows + off
                xv = win[:, rows - i0 + off - lo] if stage else Xp[:, j + pad]
                if interior:
                    acc = acc + d * xv
                else:  # a neighbour outside [0, n) is not read
                    inside = (j >= 0) & (j < n)
                    acc = torch.where(inside, acc + d * torch.where(inside, xv, 0.0), acc)
        Y[:, rows] = acc
        writes[rows] += 1
    return Y, writes


#: DIA matrices with offsets reaching past both ends of [0, n): banded |sin|
#: (ragged n), 2-D and 3-D Poisson as flat DIA (far offsets), a one-sided
#: band, and a random offset set wider than a block
def _dias():
    rng = np.random.default_rng(7)
    n = 777
    offs = tuple(int(o) for o in np.sort(rng.choice(np.arange(-400, 401), 23, replace=False)))
    return {
        "banded 333 band 8": generators.banded_sin_matrix(333, 8),
        "banded 1000 band 32": generators.banded_sin_matrix(1000, 32),
        "poisson2d 31": generators.poisson2d_matrix(31),
        "poisson3d 11": generators.poisson3d_matrix(11),
        "lower band 500": DiaMatrix(rng.standard_normal((3, 500)), (-70, -3, -1), (500, 500)),
        "random 777": DiaMatrix(rng.standard_normal((len(offs), n)), offs, (n, n)),
    }


@pytest.mark.parametrize("stage", [True, False])
@pytest.mark.parametrize("threads,batch", [(256, 16), (256, 8), (128, 4), (64, 3)])
@pytest.mark.parametrize("name", sorted(_dias()))
def test_spmm_schedule_matches_twin(name, threads, batch, stage):
    A = _dias()[name].device_put(torch.float64, "cpu")
    X = torch.from_numpy(np.random.default_rng(8).standard_normal((3, A.n)))
    Y, writes = spmm_schedule(A, X, threads, batch, stage)
    ref = spmm_dia_ref(A, X)
    assert torch.equal(writes, torch.ones_like(writes))
    assert not bool(torch.isnan(Y).any())
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())


def test_spmm_interior_blocks_exist_on_the_main_shapes():
    # the flagship band 160 and the 255^3 seven-diagonal operator: all but a
    # block or two at either end take the unmasked path
    for n, lo, hi in ((207_402, -79, 79), (255**3, -(255**2), 255**2)):
        blocks = math.ceil(n / 256)
        interior = sum(i0 + lo >= 0 and i0 + 256 + hi <= n for i0 in range(0, n, 256))
        assert blocks - interior <= 2 * math.ceil(-lo / 256) + 2
