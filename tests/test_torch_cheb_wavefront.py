"""Kernel #2's z-marching wavefront, emulated plane by plane on the CPU.

``csrc/stencil.cu::cheb_const_kernel`` runs only on the card, where its
stage schedule cannot be stepped through.  ``wavefront`` below replays that
schedule in torch, one block and one plane step at a time, with the
kernel's own state: an (x, y) column tile plus a halo of h, a z chunk
marched from h planes before it to h planes after it, one operand ring of
four planes per application of A, the two-deep (r, x) delay line between
stages, stale columns on the tile's outer face and zeros outside the domain.
It is held to ``cheb_smooth_const_ref`` in fp64 for every (degree, zero_x,
want_resid), for tiles and chunks that do and do not divide the grid.  The
emulation performs the twin's operations in the twin's order, so the two
agree to fp64 rounding; a wrong lag, ring slot, mask or chunk end shows as
an O(1) error near a tile or chunk edge.

The launch geometry that the wrapper chooses (``cheb_geometry``) and kernel
#3's choice of instantiation (``var_instantiation``) are pinned here too.
"""

import math

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    CHEB_CHUNKS,
    MAX_DEGREE,
    SPECIALISED_LEGS,
    _cheb_halo,
    _cheb_scalars,
    cheb_geometry,
    cheb_smooth_const_ref,
    var_instantiation,
)
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy

#: the emulation repeats the twin's fp64 operations in the same order
REL = 1e-12
#: a block's shared memory on the H100 (227 KB)
SMEM_LIMIT = 232_448

VARIANTS = [(d, z, r) for d in range(1, MAX_DEGREE + 1) for z in (True, False) for r in (False, True)]


def wavefront(A, b, x0, degree, lam_max, lam_min, inv_diag, want_resid, tile, chunk, h=None):
    """The kernel's schedule on CPU tensors: returns ``x_out`` or
    ``(x_out, r_out)``, and the number of times each point was written.
    ``h`` overrides the halo of ``cheb_geometry``."""
    geo = cheb_geometry(degree, x0 is None, want_resid)
    h, na = geo.h if h is None else h, geo.napps
    tx, ty = tile
    theta, alphas, betas = _cheb_scalars(degree, lam_max, lam_min)
    invd = float(inv_diag)
    nz, ny, nx = A.grid
    ex, ey = tx + 2 * h, ty + 2 * h
    x_out = torch.full(A.grid, float("nan"), dtype=b.dtype)
    r_out = torch.full(A.grid, float("nan"), dtype=b.dtype)
    writes = torch.zeros(A.grid, dtype=torch.int64)
    zeros = torch.zeros((ey, ex), dtype=b.dtype)
    face = torch.zeros((ey, ex), dtype=torch.bool)
    face[0, :] = face[-1, :] = face[:, 0] = face[:, -1] = True
    for by in range(math.ceil(ny / ty)):
        for bx in range(math.ceil(nx / tx)):
            gy = by * ty - h + torch.arange(ey)
            gx = bx * tx - h + torch.arange(ex)
            inxy = ((gy >= 0) & (gy < ny))[:, None] & ((gx >= 0) & (gx < nx))[None, :]
            own = torch.zeros((ey, ex), dtype=torch.bool)
            own[h : ey - h, h : ex - h] = True
            own &= inxy
            oy, ox = gy[:, None].expand(ey, ex)[own], gx[None, :].expand(ey, ex)[own]
            cy, cx = gy.clamp(0, ny - 1), gx.clamp(0, nx - 1)
            for bz in range(math.ceil(nz / chunk)):
                z0, z1 = bz * chunk, min(bz * chunk + chunk, nz)
                zload = min(z1 + h, nz)

                def load(src, t):
                    if src is None or not 0 <= t < zload:
                        return zeros
                    return torch.where(inxy, src[t][cy][:, cx], zeros)

                ring = [[zeros] * 4 for _ in range(na)]
                r1, x1, r2, x2 = ([zeros] * na for _ in range(4))
                for t in range(z0 - h, z1 + 2 * na):
                    cb, cx0 = load(b, t), load(x0, t)
                    nr, nxv = [None] * na, [None] * na
                    in0 = inxy & (0 <= t < nz)
                    if x0 is not None:  # stage 0
                        r, x = cb, cx0
                        if na:
                            ring[0][t % 4] = cx0
                    else:
                        r = invd * cb
                        x = torch.where(in0, r / theta, zeros)
                        if na:
                            ring[0][t % 4] = x
                    if na == 0:
                        if z0 <= t < z1:
                            x_out[t][oy, ox] = x[own]
                            writes[t][oy, ox] += 1
                    else:
                        nr[0], nxv[0] = r, x
                    for s in range(1, na + 1):  # stage s: application s of A at plane t - 2s
                        q = t - 2 * s
                        inq = inxy & (0 <= q < nz)
                        R = ring[s - 1]
                        a = None
                        for c, (sz, sy, sx) in zip(A.coeffs, A.shifts):
                            term = c * torch.roll(R[(q + sz) % 4], shifts=(-sy, -sx), dims=(0, 1))
                            a = term if a is None else a + term
                        r, x = r2[s - 1], x2[s - 1]
                        d = None
                        if x0 is not None and s == 1:
                            r = invd * torch.where(face, r, r - a)
                            d = torch.where(inq, r / theta, zeros)
                            x = x + d
                        else:
                            k = s - 1 - (0 if x0 is None else 1)
                            r = torch.where(face, r, r - invd * a)
                            if k < degree - 1:
                                d = torch.where(inq, alphas[k] * R[q % 4] + betas[k] * r, zeros)
                                x = x + d
                        if s < na:
                            ring[s][q % 4] = d
                            nr[s], nxv[s] = r, x
                        elif z0 <= q < z1:
                            x_out[q][oy, ox] = x[own]
                            r_out[q][oy, ox] = r[own]
                            writes[q][oy, ox] += 1
                    r2, x2, r1, x1 = r1, x1, nr, nxv
    return ((x_out, r_out) if want_resid else x_out), writes


def _const(grid):
    return stencil_to_const(dia_to_stencil(generators.poisson_system(grid).A, grid))


def _inputs(grid, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.standard_normal(grid)), torch.from_numpy(rng.standard_normal(grid)))


@pytest.mark.parametrize("degree,zero_x,want_resid", VARIANTS)
@pytest.mark.parametrize("grid,tile,chunk", [
    ((9, 13, 11), (8, 4), 4),     # chunks and tiles that do not divide the grid
    ((8, 12, 16), (8, 4), 4),     # ... and that do
    ((3, 10, 14), (32, 16), 32),  # nz below the number of stages; the kernel's own tile
])
def test_wavefront_matches_twin(grid, tile, chunk, degree, zero_x, want_resid):
    A = _const(grid)
    b, x0 = _inputs(grid, 11)
    args = (A, b, None if zero_x else x0, degree, 2.0, 0.5, 1.0 / 6.0, want_resid)
    out, writes = wavefront(*args, tile=tile, chunk=chunk)
    ref = cheb_smooth_const_ref(*args)
    assert torch.equal(writes, torch.ones_like(writes))  # tiles and chunks cover the grid once
    for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
        assert float((o - r).abs().max()) <= REL * float(r.abs().max())


def test_wavefront_matches_twin_on_a_27_leg_level():
    # the const-detected 27-leg Galerkin level 15^3 of a 31^3 Poisson hierarchy
    h = build_hierarchy(generators.poisson_system((31, 31, 31)).A, (31, 31, 31), device="cpu")
    lvl = h.levels[1]
    assert lvl.A.nlegs == 27
    b, x0 = _inputs(lvl.grid, 12)
    lo, hi = lvl.cheb_bounds
    for zero_x, want_resid in ((True, True), (False, False), (False, True)):
        args = (lvl.A, b, None if zero_x else x0, 2, hi, lo, float(lvl.inv_diag), want_resid)
        out, _ = wavefront(*args, tile=(8, 4), chunk=4)
        ref = cheb_smooth_const_ref(*args)
        for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
            assert float((o - r).abs().max()) <= REL * float(r.abs().max())


def test_wavefront_catches_an_under_budget_halo():
    # the emulation is sharp: one plane and column of halo short, and the
    # tile and chunk edges go wrong
    grid = (12, 10, 10)
    A = _const(grid)
    b, x0 = _inputs(grid, 13)
    args = (A, b, x0, 2, 2.0, 0.5, 1.0 / 6.0, True)
    h = cheb_geometry(2, False, True).h
    (_, r_short), writes = wavefront(*args, tile=(4, 4), chunk=4, h=h - 1)
    _, r_ref = cheb_smooth_const_ref(*args)
    assert torch.equal(writes, torch.ones_like(writes))
    assert float((r_short - r_ref).abs().max()) > 1e-3 * float(r_ref.abs().max())


@pytest.mark.parametrize("degree,zero_x,want_resid", VARIANTS)
def test_cheb_geometry(degree, zero_x, want_resid):
    geo = cheb_geometry(degree, zero_x, want_resid)
    assert geo.h == _cheb_halo(degree, zero_x, want_resid)
    assert geo.napps <= geo.h  # h applications of erosion budget cover the pipeline
    assert geo.napps == (0 if zero_x else 1) + degree - 1 + int(want_resid)
    tx, ty = geo.tile
    assert geo.threads == (tx + 2 * geo.h) * (ty + 2 * geo.h) <= 1024
    assert tx % 32 == 0
    assert geo.smem == geo.napps * 4 * geo.threads * 4 <= SMEM_LIMIT
    assert geo.chunk == CHEB_CHUNKS[-1]


@pytest.mark.parametrize("grid,chunk", [((255,) * 3, 128), ((127,) * 3, 16), ((63,) * 3, 16),
                                        ((511,) * 3, 128), ((3, 40, 70), 16)])
def test_cheb_chunk_gives_every_sm_a_block(grid, chunk):
    geo = cheb_geometry(2, True, True, grid, sms=132)
    assert geo.chunk == chunk
    tx, ty = geo.tile
    blocks = math.ceil(grid[2] / tx) * math.ceil(grid[1] / ty) * math.ceil(grid[0] / chunk)
    assert blocks >= 132 or chunk == CHEB_CHUNKS[-1]


def test_cheb_geometry_main_path():
    # the V-cycle's degree-2 pre-smooth (zero x0, residual) and post-smooth
    # (given x0): a 32 x 16 tile, halo 2, two stages, 23 KB of rings
    for zero_x, want_resid in ((True, True), (False, False)):
        geo = cheb_geometry(2, zero_x, want_resid)
        assert (geo.h, geo.napps, geo.tile, geo.threads, geo.smem) == (2, 2, (32, 16), 720, 23040)
        assert cheb_geometry(2, zero_x, want_resid, (255,) * 3).chunk == 128


@pytest.mark.parametrize("grid,legs", [((63, 63), [5]), ((127, 127), [5, 9]), ((31, 31, 31), [7, 27])])
def test_var_instantiation_of_hierarchy_levels(grid, legs):
    s = generators.diffusion_system(grid, contrast=1e3)
    h = build_hierarchy(s.A, grid, device="cpu")
    got = [lvl.A.nlegs for lvl in h.levels]
    assert got == legs
    assert [var_instantiation(n) for n in got] == got  # each level has its own instantiation


@pytest.mark.parametrize("nlegs", range(1, 28))
def test_var_instantiation(nlegs):
    want = nlegs if nlegs in (5, 7, 9, 27) else 0
    assert var_instantiation(nlegs) == want
    assert SPECIALISED_LEGS == (5, 7, 9, 27)
