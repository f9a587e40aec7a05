"""The rest of the multigrid build against the JAX package, on the CPU:
hierarchies with hybrid, semicoarsening and aggregation transfers, the
``layout="dia"``, ``const_detect``, ``transfer_kind`` and
``sa_smooth_levels`` options and the rbgs smoother, bit-identical to the JAX
build; a JAX hierarchy of each kind carried across by
``convert.hierarchy_from_reference`` computes the JAX V-cycle; the wide
kernel #3's twin against the JAX ``spmv_stencil`` at halo 2, and the wide
kernel's per-point arithmetic emulated in fp64; the anisotropic generators.
Inputs are made from numpy seeds and handed to both packages."""

import itertools
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.stencil import spmv_stencil as j_spmv_stencil
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu_torch.convert import hierarchy_from_reference
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_stencil_ref
from conjugategradient_tpu_torch.precond import multigrid as tmg
from test_torch_mg_solves import _systems


#: (system kind, grid, build keywords, the transfer kinds of its levels)
HIERARCHIES = {
    "poisson 32^3": ("poisson", (32, 32, 32), {}, ["hyb", "agg"]),
    "poisson 64^2": ("poisson", (64, 64), {}, ["hyb"]),
    "tridiagonal 4096": ("tridiagonal", (4096,), {}, ["agg", "hyb"]),
    "anisotropic 128^2": ("aniso", (128, 128), {}, ["semi01"] * 4),
    "anisotropic 31^3": ("aniso", (31, 31, 31), {}, ["semi110"] * 3),
    "transfer_kind fw 31^2": ("poisson", (31, 31), dict(transfer_kind="fw", max_coarse=63), ["fw"] * 2),
    "transfer_kind hyb 32^2 const_detect off": (
        "poisson", (32, 32), dict(transfer_kind="hyb", const_detect=False, max_coarse=63),
        ["hyb"] * 3),
    "transfer_kind agg 33^2 sa_smooth_levels 1": (
        "poisson", (33, 33), dict(transfer_kind="agg", sa_smooth_levels=1, max_coarse=63),
        ["agg"] * 3),
    "layout dia 64^2": ("poisson", (64, 64), dict(layout="dia"), ["hyb"]),
    "smoother rbgs 64^2": ("poisson", (64, 64), dict(smoother="rbgs"), ["hyb"]),
    "layout dia + rbgs tridiagonal 4096": ("tridiagonal", (4096,), dict(layout="dia", smoother="rbgs"),
                                           ["agg", "hyb"]),
}


def _build(case):
    kind, grid, kw, _ = HIERARCHIES[case]
    sj, st = _systems(kind, grid)
    return sj, st, grid, jmg.build_hierarchy(sj.A, grid, **kw), tmg.build_hierarchy(
        st.A, grid, device="cpu", **kw)


def _operator_fields(A):
    if isinstance(A, jfmt.ConstStencilMatrix):
        return dict(coeffs=A.coeffs, shifts=A.shifts)
    if isinstance(A, jfmt.StencilMatrix):
        return dict(legs=np.asarray(A.data), shifts=A.shifts)
    return dict(legs=np.asarray(A.data), offsets=A.offsets)


def _jax_fields(hj):
    """A JAX hierarchy of any kind as plain numpy arrays and Python values."""
    levels = []
    for l in hj.levels:
        lv = dict(grid=l.grid, cheb_bounds=l.cheb_bounds, transfer=l.transfer,
                  inv_diag=np.asarray(l.inv_diag), sa_smooth=l.sa_smooth, **_operator_fields(l.A))
        if l.weight is not None:
            lv["weight"] = np.asarray(l.weight)
        if l.mask is not None:
            lv["mask"] = np.asarray(l.mask)
        levels.append(lv)
    return dict(levels=levels, coarse_inv=np.asarray(hj.coarse_inv), smoother=hj.smoother,
                pre=hj.pre, post=hj.post, omega=hj.omega)


def _optional_equal(t, j):
    assert (t is None) == (j is None)
    if t is not None:
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("case", sorted(HIERARCHIES))
def test_hierarchy_bit_identical_to_jax(case):
    _, _, _, hj, ht = _build(case)
    assert [l.transfer for l in ht.levels] == [l.transfer for l in hj.levels] == HIERARCHIES[case][3]
    for lt, lj in zip(ht.levels, hj.levels):
        assert lt.grid == lj.grid and lt.cheb_bounds == lj.cheb_bounds
        assert lt.sa_smooth == lj.sa_smooth
        assert type(lt.A).__name__ == type(lj.A).__name__
        fields = _operator_fields(lj.A)
        if "coeffs" in fields:
            assert (lt.A.coeffs, lt.A.shifts) == (fields["coeffs"], fields["shifts"])
        else:
            assert getattr(lt.A, "shifts" if "shifts" in fields else "offsets") == fields.get(
                "shifts", fields.get("offsets"))
            np.testing.assert_array_equal(lt.A.data.numpy(), fields["legs"])
        np.testing.assert_array_equal(lt.inv_diag.numpy(), np.asarray(lj.inv_diag))
        _optional_equal(lt.weight, lj.weight)
        _optional_equal(lt.mask, lj.mask)
    np.testing.assert_array_equal(ht.coarse_inv.numpy(), np.asarray(hj.coarse_inv))
    # .to() moves every buffer, the weights and masks too
    h32 = ht.to(torch.float32)
    for l in h32.levels:
        assert l.inv_diag.dtype == torch.float32
        assert l.weight is None or l.weight.dtype == torch.float32
        assert l.mask is None or l.mask.dtype == torch.bool


@pytest.mark.parametrize("case", ["poisson 32^3", "tridiagonal 4096", "anisotropic 128^2",
                                  "layout dia 64^2", "smoother rbgs 64^2"])
def test_carried_hierarchy_computes_the_jax_v_cycle(case):
    _, _, grid, hj, _ = _build(case)
    hc = hierarchy_from_reference(**_jax_fields(hj), device="cpu")
    b = np.random.default_rng(3).standard_normal(grid)
    if HIERARCHIES[case][2].get("layout") == "dia":
        b = b.reshape(-1)
    yj = np.asarray(jmg.v_cycle(hj, jnp.asarray(b)))
    yt = tmg.v_cycle(hc, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())


def test_build_options_refuse_as_jax_does():
    s = tgen.poisson_system((31, 31))
    co = tgen.poisson_coarse_operator()
    with pytest.raises(ValueError, match="unknown layout"):
        tmg.build_hierarchy(s.A, (31, 31), layout="csr", device="cpu")
    with pytest.raises(ValueError, match="unknown transfer_kind"):
        tmg.build_hierarchy(s.A, (31, 31), transfer_kind="semi", device="cpu")
    with pytest.raises(ValueError, match="no fixed"):
        tmg.build_hierarchy(s.A, (31, 31), transfer_kind="agg", coarse_operator=co, device="cpu")
    # rediscretization where auto coarsening falls back to aggregation: the
    # build stops, and a remainder above 4 * max_coarse raises
    with pytest.raises(ValueError, match="rediscretized coarsening stopped"):
        tmg.build_hierarchy(tgen.tridiagonal_matrix(8192), (8192,), coarse_operator=co, device="cpu")
    with pytest.raises(ValueError, match="rediscretized coarsening stopped"):
        jmg.build_hierarchy(jgen.tridiagonal_matrix(8192), (8192,),
                            coarse_operator=jgen.poisson_coarse_operator())


#: stencils for the wide kernel #3 at halo 2 and beyond: (shifts, grid),
#: random legs
_BOX = {d: tuple(itertools.product(range(-2, 3), repeat=d)) for d in (1, 2, 3)}
WIDE = {
    "1-D 5 legs (33,)": (_BOX[1], (33,)),
    "2-D 21 legs (13, 16)": (tuple(s for s in _BOX[2] if abs(s[0]) + abs(s[1]) < 4), (13, 16)),
    "2-D 25 legs (1, 40)": (_BOX[2], (1, 40)),
    "3-D 81 legs (6, 7, 9)": (_BOX[3][22:103], (6, 7, 9)),
    "3-D 125 legs (5, 4, 6)": (_BOX[3], (5, 4, 6)),
    "3-D 125 legs (2, 3, 4)": (_BOX[3], (2, 3, 4)),
    "3-D 343 legs halo 3 (7, 8, 9)": (tuple(itertools.product(range(-3, 4), repeat=3)), (7, 8, 9)),
}


def _wide(case, dtype=np.float64):
    shifts, grid = WIDE[case]
    rng = np.random.default_rng(len(shifts) + len(grid))
    return shifts, grid, rng.uniform(-1, 1, (len(shifts),) + grid).astype(dtype), \
        rng.standard_normal(grid).astype(dtype)


@pytest.mark.parametrize("case", sorted(WIDE))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_wide_twin_matches_jax_spmv_stencil(case, dtype):
    shifts, grid, legs, x = _wide(case, dtype)
    A = tfmt.StencilMatrix(torch.from_numpy(legs), shifts, grid)
    assert cuda_stencil.var_route(A) == "wide"
    y_t = spmv_stencil_ref(A, torch.from_numpy(x)).numpy()
    y_j = np.asarray(j_spmv_stencil(jfmt.StencilMatrix(jnp.asarray(legs), shifts, grid),
                                    jnp.asarray(x)))
    rtol = 1e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(y_t, y_j, rtol=rtol, atol=rtol * np.abs(y_j).max())


def _wide_kernel_emulated(legs, shifts, grid, x):
    """The wide kernel's arithmetic in fp64 on the view and leg table the
    wrapper hands it (``cuda_stencil.wide_view``: a 1-D grid as (1, 1, n),
    a 2-D one as (ny, 1, nx), folded flat offsets): per point each leg in
    order, skipped where its neighbour leaves the view, into a running
    sum."""
    view = cuda_stencil.wide_view(tuple(grid), tuple(shifts))
    nz, ny, nx = view.dims
    assert nz * ny * nx == x.size
    iz, iy, ix = np.meshgrid(np.arange(nz), np.arange(ny), np.arange(nx), indexing="ij")
    p = ((iz * ny + iy) * nx + ix).reshape(-1)
    xf, lf = x.reshape(-1), legs.reshape(len(shifts), -1)
    acc = np.zeros(p.size)
    for k, ((sz, sy, sx), off) in enumerate(zip(view.shifts, view.offsets)):
        inside = ((iz + sz >= 0) & (iz + sz < nz) & (iy + sy >= 0) & (iy + sy < ny)
                  & (ix + sx >= 0) & (ix + sx < nx)).reshape(-1)
        acc[p[inside]] += lf[k, p[inside]] * xf[p[inside] + off]
    return acc.reshape(grid)


@pytest.mark.parametrize("case", sorted(WIDE))
def test_wide_kernel_emulation_matches_twin_fp64(case):
    shifts, grid, legs, x = _wide(case)
    y_e = _wide_kernel_emulated(legs, shifts, grid, x)
    y_t = spmv_stencil_ref(tfmt.StencilMatrix(torch.from_numpy(legs), shifts, grid),
                           torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_e, y_t, rtol=1e-12, atol=1e-12 * np.abs(y_t).max())


def test_wide_table_encodes_the_view():
    # each leg's folded offset, and (sz, sy, sx) as signed bytes 0-2
    shifts = tuple(itertools.product(range(-7, 8, 7), repeat=2))
    for grid in [(20, 30), (1, 30)]:
        view = cuda_stencil.wide_view(grid, shifts)
        assert view.dims == (grid[0], 1, grid[1])
        table = cuda_stencil._wide_table(view, torch.device("cpu")).numpy()
        assert table.shape == (len(shifts), 2) and table.dtype == np.int32
        np.testing.assert_array_equal(table[:, 0], view.offsets)
        decoded = [tuple(int(np.int8(np.uint8((int(v) >> (8 * b)) & 0xFF))) for b in range(3))
                   for v in table[:, 1]]
        assert decoded == list(view.shifts)
        assert all(s[1] == 0 for s in view.shifts)  # the 1-row axis moves no leg
    assert cuda_stencil.wide_view((5, 6, 7), ((1, -2, 3),)) == ((5, 6, 7), ((1, -2, 3),),
                                                                 (1 * 42 - 2 * 7 + 3,))
    assert cuda_stencil.wide_view((9,), ((-2,),)).dims == (1, 1, 9)


@pytest.mark.parametrize("grid,zrun", [((128, 128, 128), 4), ((256, 256, 256), 4), ((32, 32, 32), 1),
                                       ((16, 16, 16), 1), ((512, 512), 1), ((1024, 1024), 1),
                                       ((70000, 8), 4), ((32768,), 1)])
def test_wide_zrun_fills_the_card(grid, zrun):
    # runs of four planes only where they still give every SM 2048 threads
    # (or one plane a block would pass the launch's 65,535 z blocks)
    view = cuda_stencil.wide_view(grid, ((0,) * len(grid),))
    assert cuda_stencil.wide_zrun(view, sms=132) == zrun


def test_route_cache_follows_each_shifts_tuple():
    # var_route caches a leg list's halo by the identity of its shifts
    # tuple: fresh tuples, past the cache's 512 entries, still route by
    # their own shifts
    for k in range(1200):
        h = k % 4
        shifts = tuple(itertools.product(range(-h, h + 1), repeat=2)) + ((0, k),)
        A = tfmt.StencilMatrix(torch.zeros((len(shifts), 3, k + 1)), shifts, (3, k + 1))
        want = "narrow" if max(h, k) <= 1 and len(shifts) <= 27 else "wide"
        if max(h, k) > cuda_stencil.WIDE_HALO:
            with pytest.raises(ValueError, match="shifts must be in"):
                cuda_stencil.var_route(A)
        else:
            assert cuda_stencil.var_route(A) == want


@pytest.mark.parametrize("name", ["WIDE_LEGS", "WIDE_HALO", "WIDE_ZRUN"])
def test_wide_limits_match_the_c_source(name):
    # the wrapper's routing and launch geometry rest on the kernel's limits
    src = (pathlib.Path(cuda_stencil.__file__).parent.parent / "csrc" / "stencil_var.cu").read_text()
    assert int(re.search(rf"#define {name} (\d+)", src).group(1)) == getattr(cuda_stencil, name)


@pytest.mark.parametrize("grid,ratios", [((9,), (2.0,)), ((7, 6), (1e-3, 1.0)),
                                         ((5, 4, 3), (1.0, 1.0, 1e-3))])
def test_anisotropic_generators_bit_identical(grid, ratios):
    sj = jgen.anisotropic_diffusion_system(grid, ratios, seed=2)
    st = tgen.anisotropic_diffusion_system(grid, ratios, seed=2)
    assert st.A.offsets == sj.A.offsets and st.A.shape == sj.A.shape
    np.testing.assert_array_equal(st.A.data, np.asarray(sj.A.data))
    np.testing.assert_array_equal(st.b, sj.b)
    np.testing.assert_array_equal(st.x0, sj.x0)
    with pytest.raises(ValueError, match="ratios"):
        tgen.anisotropic_diffusion_matrix(grid, ratios + (1.0,))
