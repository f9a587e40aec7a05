"""The schedule of the wide kernel #3 (``csrc/stencil_var.cu::
spmv_var_wide_kernel``) emulated on the CPU: the legs split across threads.

The kernel runs only on the card.  ``wide_schedule`` below replays its
launch in torch with the kernel's own decisions, for every thread of the
launch at once: the view of ``wide_view``, the leg table of ``_wide_table``
(decoded here as the kernel decodes it), the launch of ``wide_geometry``
(``block`` lanes x rows of points, ``split`` slices, ``zrun`` planes, the
blocks of ``grid``), each thread's slice of the leg list as the kernel
computes it (``wide_slices``), a leg skipped where its neighbour leaves the
view (the (y, x) test and the z test), the slice's terms added in order
into a running sum, and at split > 1 the partials added in slice order by
the slice-0 thread of each point.

x lies between NaNs, so a read that the tests should have skipped, or one
past the grid, shows as a NaN.  The emulation repeats the twin's fp64
operations, grouped by slice, so the two agree to fp64 rounding (1e-12 of
the largest |twin| entry), and exactly at split 1.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core.formats import StencilMatrix
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    WIDE_MAX_THREADS,
    WIDE_THREADS,
    spmv_stencil_ref,
    wide_geometry,
    wide_slices,
    wide_split,
    wide_view,
)

#: the emulation repeats the twin's fp64 operations, grouped by slice
REL = 1e-12
_SRC = (Path(cuda_stencil.__file__).parents[1] / "csrc" / "stencil_var.cu").read_text()
#: a block gets 48 KB of shared memory without opting in
SMEM_LIMIT = 48 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs thousands of small torch ops: one intra-op thread
    keeps the suite's parallel workers from oversubscribing the cores (with
    every worker's default threads, a 3 s test ran for minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _SRC).group(1))


def _decode(view):
    """The leg table as the kernel reads it: (offset, sz, sy, sx) per leg."""
    table = cuda_stencil._wide_table(view, torch.device("cpu")).numpy()
    sh = [[int(np.int8(np.uint8((int(v) >> (8 * b)) & 0xFF))) for b in range(3)] for v in table[:, 1]]
    return table[:, 0].astype(np.int64), np.array(sh, dtype=np.int64).reshape(-1, 3)


def wide_schedule(A, x, geo):
    """The wide kernel's launch ``geo`` on CPU tensors: returns y and how
    often each point was written."""
    view = wide_view(tuple(A.grid), tuple(A.shifts))
    nz, ny, nx = view.dims
    (bx, rows), split, zr, (gx, gy, gz) = geo
    plane = ny * nx
    n = plane * nz
    offs, sh = _decode(view)
    pad = int(np.abs(offs).max()) + 1
    nan = torch.full((pad,), float("nan"), dtype=x.dtype)
    xp = torch.cat([nan, x.reshape(-1), nan])
    legs = A.data.reshape(A.nlegs, -1)
    # every thread of the launch, by (block z, block y, block x, slice, row,
    # lane); blockDim = (bx, rows * split), slice = threadIdx.y / rows
    bz, by_, bxx, s, ty, tx = (torch.from_numpy(a.reshape(-1)) for a in np.meshgrid(
        np.arange(gz), np.arange(gy), np.arange(gx), np.arange(split), np.arange(rows),
        np.arange(bx), indexing="ij"))
    ix, iy, z0 = bxx * bx + tx, by_ * rows + ty, bz * zr
    live = (ix < nx) & (iy < ny) & (z0 < nz)
    p0 = (z0 * ny + iy) * nx + ix
    part = torch.zeros((zr, s.numel()), dtype=x.dtype)
    for u, (lo, hi) in enumerate(wide_slices(A.nlegs, split)):
        mine = live & (s == u)
        for k in range(lo, hi):
            inxy = mine & ((iy + sh[k, 1]) >= 0) & ((iy + sh[k, 1]) < ny) \
                & ((ix + sh[k, 2]) >= 0) & ((ix + sh[k, 2]) < nx)
            for r in range(zr):
                z = z0 + r + sh[k, 0]
                inside = inxy & (z0 + r < nz) & (z >= 0) & (z < nz)
                p = (p0 + r * plane).clamp(0, n - 1)
                term = legs[k, p] * xp[p + offs[k] + pad]
                part[r] = torch.where(inside, part[r] + term, part[r])
    # the partials of a point's slices, added in slice order by slice 0
    part = part.reshape(zr, gz, gy, gx, split, rows, bx)
    total = part[:, :, :, :, 0]
    for u in range(1, split):
        total = total + part[:, :, :, :, u]
    first = s.reshape(gz, gy, gx, split, rows, bx)[:, :, :, 0] == 0
    y = torch.full((n,), float("nan"), dtype=x.dtype)
    writes = torch.zeros(n, dtype=torch.int64)
    head = (live.reshape(gz, gy, gx, split, rows, bx)[:, :, :, 0] & first).reshape(-1)
    for r in range(zr):
        ok = head & (z0.reshape(gz, gy, gx, split, rows, bx)[:, :, :, 0].reshape(-1) + r < nz)
        q = (p0.reshape(gz, gy, gx, split, rows, bx)[:, :, :, 0].reshape(-1) + r * plane)[ok]
        y[q] = total[r].reshape(-1)[ok]
        writes.index_add_(0, q, torch.ones_like(q))
    return y.reshape(A.grid), writes.reshape(A.grid)


_BOX1 = tuple((s,) for s in range(-2, 3))
_BOX2 = tuple(itertools.product(range(-2, 3), repeat=2))
_BOX3 = tuple(itertools.product(range(-2, 3), repeat=3))
#: the card tests' hand-made stencils: the halo-2 box on 1-D, 2-D and 3-D
#: grids, each rank's Galerkin leg counts (5, 21, 25, 81, 125), the
#: aggregation levels' halo-3 and halo-5 boxes (343 and 1331 legs), halo 7,
#: odd and even extents, nz = 1 and grids smaller than the halo
CASES = {
    "5 legs 1-D (4097,)": (_BOX1, (4097,)),
    "5 legs 1-D (3,)": (_BOX1, (3,)),
    "21 legs 2-D (63, 64)": (tuple(s for s in _BOX2 if abs(s[0]) + abs(s[1]) < 4), (63, 64)),
    "25 legs 2-D nz=1 (1, 300)": (_BOX2, (1, 300)),
    "49 legs 2-D halo 3 (33, 70)": (tuple(itertools.product(range(-3, 4), repeat=2)), (33, 70)),
    "81 legs 3-D (17, 16, 33)": (_BOX3[22:103], (17, 16, 33)),
    "125 legs 3-D (9, 10, 11)": (_BOX3, (9, 10, 11)),
    "125 legs 3-D (2, 3, 4)": (_BOX3, (2, 3, 4)),
    "343 legs 3-D halo 3 (9, 10, 11)": (tuple(itertools.product(range(-3, 4), repeat=3)), (9, 10, 11)),
    "1331 legs 3-D halo 5 (12, 11, 13)": (tuple(itertools.product(range(-5, 6), repeat=3)),
                                          (12, 11, 13)),
    "15 legs 1-D halo 7 (100,)": (tuple((s,) for s in range(-7, 8)), (100,)),
}


def _case(name, seed=3):
    shifts, grid = CASES[name]
    rng = np.random.default_rng(seed)
    A = StencilMatrix(torch.from_numpy(rng.uniform(-1, 1, (len(shifts),) + grid)), shifts, grid)
    return A, torch.from_numpy(rng.standard_normal(grid))


def _most(view, nlegs):
    """The largest split a block of one row of points holds."""
    return min(nlegs, WIDE_MAX_THREADS // wide_geometry(view, 1).block[0])


@pytest.mark.parametrize("split", ["auto", 1, 3, "most"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_wide_schedule_matches_twin(name, split):
    A, x = _case(name)
    view = wide_view(A.grid, A.shifts)
    s = {"auto": None, "most": _most(view, A.nlegs)}.get(split, split)
    s = None if s is None else min(s, A.nlegs)
    geo = wide_geometry(view, A.nlegs, split=s)
    y, writes = wide_schedule(A, x, geo)
    ref = spmv_stencil_ref(A, x)
    assert torch.equal(writes, torch.ones_like(writes))  # the launch covers the grid once
    assert not bool(torch.isnan(y).any())  # nothing outside the grid was read
    err = float((y - ref).abs().max())
    if geo.split == 1:
        assert err == 0.0  # the twin's order, term by term
    else:
        assert err <= REL * float(ref.abs().max())


@pytest.mark.parametrize("name", sorted(c for c in CASES if np.prod(CASES[c][1]) > 100))
def test_wide_schedule_keeps_the_twins_nans(name):
    # NaNs planted at both grid corners reach exactly the points whose
    # in-grid neighbourhood holds a corner, under the largest split too (on
    # the tiniest grids they reach every point)
    A, x = _case(name)
    x[(0,) * x.ndim] = float("nan")
    x[tuple(g - 1 for g in x.shape)] = float("nan")
    view = wide_view(A.grid, A.shifts)
    ref = spmv_stencil_ref(A, x)
    nan = torch.isnan(ref)
    assert 0 < int(nan.sum()) < nan.numel()
    for split in sorted({1, _most(view, A.nlegs)}):
        y, _ = wide_schedule(A, x, wide_geometry(view, A.nlegs, split=split))
        assert torch.equal(torch.isnan(y), nan)
        assert float((y[~nan] - ref[~nan]).abs().max()) <= REL * float(ref[~nan].abs().max())


#: the 256^3 Galerkin hierarchy's wide levels and the other paths' main
#: shapes: (grid, legs, max |shift|)
SHAPES = {
    "128^3 x 81": ((128, 128, 128), 81, 2),
    "64^3 x 125": ((64, 64, 64), 125, 2),
    "32^3 x 343": ((32, 32, 32), 343, 3),
    "16^3 x 1331": ((16, 16, 16), 1331, 5),
    "512^2 x 21": ((512, 512), 21, 2),
    "1-D 32768 x 5": ((32768,), 5, 2),
}


def _view(label):
    grid, nlegs, h = SHAPES[label]
    box = tuple(itertools.product(range(-h, h + 1), repeat=len(grid)))
    return wide_view(grid, box[:nlegs]), nlegs


def test_wide_geometry_splits_only_where_the_points_do_not_fill_the_card():
    want = {"128^3 x 81": 1, "512^2 x 21": 1, "1-D 32768 x 5": 1, "64^3 x 125": 1,
            "32^3 x 343": 4, "16^3 x 1331": 32}
    got = {label: wide_split(*_view(label), sms=132) for label in SHAPES}
    assert got == want
    # the unsplit launches are the first design's: (32, 8) blocks with runs
    # of WIDE_ZRUN planes at 128^3, one row of 256 threads a plane at 512^2
    assert wide_geometry(*_view("128^3 x 81"), sms=132) == ((32, 8), 1, 4, (4, 16, 32))
    assert wide_geometry(*_view("512^2 x 21"), sms=132) == ((256, 1), 1, 1, (2, 1, 512))
    # the split ones keep a slice's WIDE_MIN_SLICE legs, one plane a thread,
    # and run in one wave of WIDE_SPLIT_THREADS_PER_SM threads an SM
    for label in ("32^3 x 343", "16^3 x 1331"):
        view, nlegs = _view(label)
        geo = wide_geometry(view, nlegs, sms=132)
        assert geo.zrun == 1 and nlegs // geo.split >= cuda_stencil.WIDE_MIN_SLICE
        assert geo.block[0] * geo.block[1] * geo.split <= WIDE_MAX_THREADS
        threads = geo.block[0] * geo.block[1] * geo.split * np.prod(geo.grid)
        assert threads <= 132 * cuda_stencil.WIDE_SPLIT_THREADS_PER_SM < 2 * threads


@pytest.mark.parametrize("label", sorted(SHAPES))
@pytest.mark.parametrize("split", [None, 1, 2, 5, 16])
def test_wide_geometry_covers_the_view_within_the_kernels_limits(label, split):
    view, nlegs = _view(label)
    nz, ny, nx = view.dims
    try:
        geo = wide_geometry(view, nlegs, sms=132, split=split)
    except ValueError as e:  # more slices than legs, or than a block holds
        assert split > nlegs or split * wide_geometry(view, 1).block[0] > WIDE_MAX_THREADS, e
        return
    (bx, rows), s, zr, (gx, gy, gz) = geo
    threads = bx * rows * s
    assert threads <= (WIDE_THREADS if s == 1 else WIDE_MAX_THREADS)
    assert zr in (1, cuda_stencil.WIDE_ZRUN) and (zr == 1 or s == 1)
    # exactly the blocks that cover the view (the C entry refuses others)
    assert (gx, gy, gz) == (-(-nx // bx), -(-ny // rows), -(-nz // zr))
    assert gy <= 65535 and gz <= 65535
    # the staged table and the partials fit a block's shared memory
    table = -(-nlegs * 8 // 16) * 16
    assert table + (threads * 8 if s > 1 else 0) <= SMEM_LIMIT


def test_wide_geometry_refuses_splits_the_kernel_does_not_take():
    view, nlegs = _view("16^3 x 1331")
    with pytest.raises(ValueError, match="split must be in"):
        wide_geometry(view, 5, split=6)
    with pytest.raises(ValueError, match="slices on rows"):
        wide_geometry(view, nlegs, split=128)
    with pytest.raises(ValueError, match="split must be in"):
        wide_geometry(view, nlegs, split=0)


@pytest.mark.parametrize("nlegs", [1, 5, 21, 81, 125, 343, 1331, 3375])
def test_wide_slices_cover_the_legs_in_order(nlegs):
    for split in range(1, min(nlegs, 64) + 1):
        slices = wide_slices(nlegs, split)
        assert len(slices) == split
        assert slices[0][0] == 0 and slices[-1][1] == nlegs
        assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # in order, no gap
        sizes = [hi - lo for lo, hi in slices]
        assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1  # none empty, balanced


def test_wide_constants_and_slices_match_the_c_source():
    assert _define("WIDE_THREADS") == WIDE_THREADS
    assert _define("WIDE_MAX_THREADS") == WIDE_MAX_THREADS
    assert _define("WIDE_ZRUN") == cuda_stencil.WIDE_ZRUN
    # the kernel's slice bounds are wide_slices'
    assert "lo = (int)((long long)s * nlegs / split)" in _SRC
    assert "hi = (int)((long long)(s + 1) * nlegs / split)" in _SRC
    # the largest table and a full block of fp64 partials fit 48 KB
    assert -(-_define("WIDE_LEGS") * 8 // 16) * 16 + WIDE_MAX_THREADS * 8 <= SMEM_LIMIT
