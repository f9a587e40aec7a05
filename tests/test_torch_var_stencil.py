"""The variable-coefficient MGCG path of the port against the JAX package, on
the CPU: the diffusion generators, kernel #3's plain twin (held to the
Pallas kernel in interpret mode), the Galerkin product, the spectral bounds,
the Galerkin hierarchy, one V-cycle, MGCG and the bf16-leg refined solve.
Inputs are made from numpy seeds and handed to both packages."""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.pallas_stencil import spmv_stencil_pallas
from conjugategradient_tpu.ops.stencil import spmv_stencil as j_spmv_stencil
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers import eigen as jeig
from conjugategradient_tpu.solvers.refine import refined_solve as j_refined
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import hierarchy_from_reference
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_stencil_cuda, spmv_stencil_ref
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.ops.stencil import spmv_stencil
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers import eigen as teig
from conjugategradient_tpu_torch.solvers.refine import refined_solve


def _systems(grid, kind="jump", contrast=1e3, seed=0, dtype=np.float64):
    """(JAX, port) diffusion systems of one configuration."""
    kw = dict(kind=kind, contrast=contrast, seed=seed, dtype=dtype)
    return jgen.diffusion_system(grid, **kw), tgen.diffusion_system(grid, **kw)


def _jax_fields(hj):
    """A JAX Galerkin hierarchy as plain numpy arrays and Python values."""
    levels = []
    for l in hj.levels:
        lv = dict(shifts=l.A.shifts, grid=l.grid, cheb_bounds=l.cheb_bounds,
                  transfer=l.transfer, inv_diag=np.asarray(l.inv_diag))
        if isinstance(l.A, jfmt.ConstStencilMatrix):
            lv["coeffs"] = l.A.coeffs
        else:
            lv["legs"] = np.asarray(l.A.data)
        levels.append(lv)
    return dict(levels=levels, coarse_inv=np.asarray(hj.coarse_inv), smoother=hj.smoother,
                pre=hj.pre, post=hj.post, omega=hj.omega)


@pytest.mark.parametrize("grid", [(9,), (5, 7), (4, 3, 5), (17, 13, 11)])
@pytest.mark.parametrize("kind", ["jump", "smooth", "const"])
def test_diffusion_generators_bit_identical(grid, kind):
    a_j = jgen.diffusion_coefficients(grid, kind=kind, contrast=1e3, seed=2)
    a_t = tgen.diffusion_coefficients(grid, kind=kind, contrast=1e3, seed=2)
    np.testing.assert_array_equal(a_t, a_j)
    sj, st = _systems(grid, kind=kind, seed=2)
    assert st.A.offsets == sj.A.offsets and st.A.shape == sj.A.shape
    np.testing.assert_array_equal(st.A.data, np.asarray(sj.A.data))
    np.testing.assert_array_equal(st.b, sj.b)
    np.testing.assert_array_equal(st.x0, sj.x0)
    with pytest.raises(ValueError, match="unknown coefficient kind"):
        tgen.diffusion_coefficients(grid, kind="nope")


@pytest.mark.parametrize("grid", [(17, 13, 11), (25, 19)])
@pytest.mark.parametrize("bz", [0, 8])
def test_var_twin_matches_pallas_interpret(grid, bz):
    # fp32 legs within 2e-6 relative, bf16 legs within 1e-6 relative of the
    # JAX bf16 path: the bounds of tests/test_pallas_stencil.py's
    # variable-coefficient kernel test
    sj, st = _systems(grid, dtype=np.float32)
    jA = jfmt.dia_to_stencil(sj.A, grid)
    tA = tfmt.dia_to_stencil(st.A, grid).device_put()
    assert tA.shifts == jA.shifts
    x = np.random.default_rng(0).standard_normal(grid).astype(np.float32)
    y_t = spmv_stencil_ref(tA, torch.from_numpy(x)).numpy()
    y_j = np.asarray(spmv_stencil_pallas(jA, jnp.asarray(x), bz=bz, interpret=True))
    scale = np.abs(y_j).max()
    assert np.abs(y_t - y_j).max() / scale < 2e-6
    y_tb = spmv_stencil_ref(tA.astype(torch.bfloat16), torch.from_numpy(x))
    assert y_tb.dtype == torch.float32
    y_jb = np.asarray(spmv_stencil_pallas(jA.astype(jnp.bfloat16), jnp.asarray(x), bz=bz,
                                          interpret=True))
    assert np.abs(y_tb.numpy() - y_jb).max() / scale < 1e-6
    assert np.abs(y_tb.numpy() - y_t).max() / scale > 1e-6  # the legs really are rounded


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_27_leg_galerkin_level_matches_jax(dtype):
    fine = (15, 13, 11)
    sj, _ = _systems(fine)
    Ac = jmg.galerkin_coarse(sj.A, fine, "fw")
    coarse = (7, 6, 5)
    jA = jfmt.dia_to_stencil(Ac, coarse).astype(dtype)
    tA = tfmt.StencilMatrix(np.asarray(jA.data), jA.shifts, jA.grid).device_put()
    assert tA.nlegs == 27
    x = np.random.default_rng(1).standard_normal(coarse).astype(dtype)
    y_j = np.asarray(j_spmv_stencil(jA, jnp.asarray(x)))
    y_t = spmv_stencil(tA, torch.from_numpy(x))
    rtol = 1e-6 if dtype == np.float32 else 1e-13
    np.testing.assert_allclose(y_t.numpy(), y_j, rtol=rtol, atol=rtol * np.abs(y_j).max())
    # the same product through as_operator on the host matrix, flat in and out
    y_f = as_operator(tfmt.StencilMatrix(np.asarray(jA.data), jA.shifts, jA.grid))(
        torch.from_numpy(x.reshape(-1)))
    assert y_f.shape == (x.size,)
    assert torch.equal(y_f, y_t.reshape(-1))


@pytest.mark.parametrize("grid", [(31, 27), (15, 13, 11)])
def test_galerkin_and_bounds_bit_identical(grid):
    sj, st = _systems(grid, contrast=1e4)
    cj = jmg.galerkin_coarse(sj.A, grid, "fw")
    ct = tmg.galerkin_coarse(st.A, grid, "fw")
    assert ct.offsets == cj.offsets and ct.shape == cj.shape
    np.testing.assert_array_equal(ct.data, np.asarray(cj.data))
    assert teig.scaled_spectrum_bounds(st.A) == jeig.scaled_spectrum_bounds(sj.A)
    assert teig.scaled_spectrum_bounds(ct) == jeig.scaled_spectrum_bounds(cj)
    # smoothed aggregation, ported: the JAX package's product bit for bit
    aj = jmg.galerkin_coarse(sj.A, grid, "agg")
    at = tmg.galerkin_coarse(st.A, grid, "agg")
    assert at.offsets == aj.offsets
    np.testing.assert_array_equal(at.data, np.asarray(aj.data))


HIERARCHIES = {
    "jump 63^2 contrast 1e4": ((63, 63), "jump", 1e4),
    "jump 15^3": ((15, 15, 15), "jump", 1e3),
    "jump 31^3": ((31, 31, 31), "jump", 1e3),
    "poisson 31^3": ((31, 31, 31), "const", 1e3),
}


@pytest.mark.parametrize("case", sorted(HIERARCHIES))
def test_galerkin_hierarchy_matches_jax(case):
    grid, kind, contrast = HIERARCHIES[case]
    sj, st = _systems(grid, kind=kind, contrast=contrast)
    hj = jmg.build_hierarchy(sj.A, grid)
    ht = tmg.build_hierarchy(st.A, grid)  # no coarse_operator: Galerkin
    assert len(ht.levels) == len(hj.levels) > 0
    for lt, lj in zip(ht.levels, hj.levels):
        assert lt.grid == lj.grid and lt.transfer == lj.transfer == "fw"
        assert lt.cheb_bounds == lj.cheb_bounds
        assert type(lt.A).__name__ == type(lj.A).__name__
        assert lt.A.shifts == lj.A.shifts
        np.testing.assert_array_equal(lt.inv_diag.numpy(), np.asarray(lj.inv_diag))
        buffers = {n for n, _ in lt.named_buffers()}
        if isinstance(lj.A, jfmt.ConstStencilMatrix):
            assert lt.A.coeffs == lj.A.coeffs and lt.inv_diag.ndim == 0
            assert buffers == {"inv_diag"}
        else:
            assert lt.inv_diag.shape == lt.grid and buffers == {"legs", "inv_diag"}
            np.testing.assert_array_equal(lt.A.data.numpy(), np.asarray(lj.A.data))
    np.testing.assert_array_equal(ht.coarse_inv.numpy(), np.asarray(hj.coarse_inv))
    if kind == "const":  # Poisson's Galerkin levels const-detect: 7 legs, then 27
        assert [l.A.nlegs for l in ht.levels] == [7, 27]


@pytest.mark.parametrize("grid", [(63, 63), (31, 31, 31)])
def test_v_cycle_on_carried_hierarchy_matches_jax_fp64(grid):
    sj, _ = _systems(grid, contrast=1e4)
    hj = jmg.build_hierarchy(sj.A, grid)
    hc = hierarchy_from_reference(**_jax_fields(hj))
    assert all(isinstance(l.A, tfmt.StencilMatrix) for l in hc.levels)
    b = np.random.default_rng(4).standard_normal(grid)
    yj = np.asarray(jmg.v_cycle(hj, jnp.asarray(b)))
    yt = tmg.v_cycle(hc, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12 * np.abs(yj).max())


@pytest.mark.parametrize("grid,contrast", [((63, 63), 1e4), ((31, 31, 31), 1e3), ((31, 31), 1e4)])
def test_mgcg_fp64_equal_iterations(grid, contrast):
    # (31, 31) is below max_coarse: no levels, the dense inverse is M
    sj, st = _systems(grid, contrast=contrast)
    kw = dict(method="mgcg", grid=grid, tol=1e-10, norm="rel_l2")
    rt = api.solve(st.A, st.b, device="cpu", **kw)
    rj = japi.solve(sj.A, sj.b, **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9,
                               atol=1e-12 * np.abs(np.asarray(rj.x)).max())
    r = st.b - oracle.spmv(st.A, rt.x.numpy())
    assert np.linalg.norm(r) / np.linalg.norm(st.b) < 1e-10


REFINE = {
    # smooth coefficients: inside the bf16 envelope, converges
    "smooth (31, 33)": ((31, 33), "smooth", 1e3, 7, dict(tol=1e-8, norm="l2"), True),
    # contrast 1e4 on an odd grid: kappa(A) * 2^-8 > 1, reports not converged
    "jump (33, 33) 1e4": ((33, 33), "jump", 1e4, 1, dict(tol=1e-9, max_outer=6), False),
}


@pytest.mark.parametrize("case", sorted(REFINE))
@pytest.mark.parametrize("device_residual", [False, True])
def test_bf16_leg_refined_solve_matches_jax(case, device_residual):
    grid, kind, contrast, seed, kw, converges = REFINE[case]
    sj, st = _systems(grid, kind=kind, contrast=contrast, seed=seed)
    kw = dict(kw, grid=grid, inner_tol=1e-4, device_residual=device_residual)
    rt = refined_solve(st.A, st.b, matrix_dtype=torch.bfloat16, **kw)
    rj = j_refined(sj.A, sj.b, matrix_dtype=jnp.bfloat16, **kw)
    assert rt.converged == rj.converged == converges
    assert rt.outer_iterations == rj.outer_iterations
    assert rt.inner_iterations == rj.inner_iterations
    if converges:
        assert np.linalg.norm(st.b - oracle.spmv(st.A, rt.x)) < kw["tol"]


def test_cpu_wrapper_uses_twin_and_launches_nothing():
    cuda_stencil.reset_launch_counts()
    g = (9, 8, 7)
    _, st = _systems(g, dtype=np.float32)
    A = tfmt.dia_to_stencil(st.A, g).device_put()
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(g).astype(np.float32))
    assert torch.equal(spmv_stencil_cuda(A, x), spmv_stencil_ref(A, x))
    # fp64 state with fp32 legs on the CPU goes to the twin too
    assert spmv_stencil_cuda(A, x.double()).dtype == torch.float64
    with pytest.raises(ValueError, match="not compatible"):
        spmv_stencil(A, x.reshape(-1)[:-1])
    assert spmv_stencil_cuda.launches == 0
    assert not spmv_stencil_cuda.launches_by_grid and not spmv_stencil_cuda.launches_by_dtype


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_stencil(grid, shifts, dtype=torch.float32):
    return tfmt.StencilMatrix(_meta((len(shifts),) + grid, dtype), shifts, grid)


def test_kernel_path_rejects_what_the_kernel_does_not_take():
    s3 = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    A = _meta_stencil((9, 9, 9), s3)
    x = _meta((9, 9, 9))
    # wrong dtype pairs: fp64 legs with fp32 state, bf16 legs with bf16 state
    with pytest.raises(TypeError, match="no kernel"):
        spmv_stencil_cuda(_meta_stencil((9, 9, 9), s3, torch.float64), x)
    with pytest.raises(TypeError, match="no kernel"):
        spmv_stencil_cuda(_meta_stencil((9, 9, 9), s3, torch.bfloat16), x.bfloat16())
    # non-contiguous x, wrong shape
    with pytest.raises(ValueError, match="contiguous"):
        spmv_stencil_cuda(A, x.transpose(0, 2))
    with pytest.raises(ValueError, match="not grid"):
        spmv_stencil_cuda(A, _meta((729,)))
    # beyond the wide kernel: more than 3375 legs, |shift| > 7, a 4-D grid;
    # host legs
    s5 = tuple(itertools.product(range(-2, 3), repeat=3))
    with pytest.raises(ValueError, match="legs supported"):
        spmv_stencil_cuda(_meta_stencil((9, 9, 9), ((0, 0, 0),) * (cuda_stencil.WIDE_LEGS + 1)), x)
    with pytest.raises(ValueError, match="shifts"):
        spmv_stencil_cuda(_meta_stencil((19, 19), ((0, 8), (0, 0))), _meta((19, 19)))
    with pytest.raises(ValueError, match="1-D, 2-D or 3-D"):
        spmv_stencil_cuda(_meta_stencil((3, 3, 3, 3), ((0, 0, 0, 0),)), _meta((3, 3, 3, 3)))
    # within it, the routes: the tuned kernel at halo 1, the wide one beyond
    assert cuda_stencil.var_route(_meta_stencil((9, 9, 9), s3)) == "narrow"
    for A_w in (_meta_stencil((9, 9, 9), s3 + ((0, 0, 0),)), _meta_stencil((9, 9, 9), s5),
                _meta_stencil((9, 9), ((0, 2), (0, 0))), _meta_stencil((9,), ((-1,), (0,), (1,))),
                _meta_stencil((19, 19), ((0, 7), (-5, 0)))):
        assert cuda_stencil.var_route(A_w) == "wide"
        with pytest.raises(ValueError, match="CUDA"):  # checked as far as the device
            spmv_stencil_cuda(A_w, _meta(A_w.grid))
    with pytest.raises(TypeError, match="torch tensor"):
        spmv_stencil_cuda(tfmt.StencilMatrix(np.zeros((1, 9, 9)), ((0, 0),), (9, 9)), _meta((9, 9)))
    # a device that is neither the CPU nor CUDA
    with pytest.raises(ValueError, match="CUDA"):
        spmv_stencil_cuda(A, x)
    assert spmv_stencil_cuda.launches == 0
