"""The port's host setup and multigrid pieces against the JAX package, on the
CPU: generators, format conversions, ``build_hierarchy`` (held to the JAX
build carried across by ``convert.hierarchy_from_reference``), transfers,
smoothers and one V-cycle."""

from functools import partial

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import oracle as jor
from conjugategradient_tpu.ops.stencil import spmv_const_stencil as j_spmv_const
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.precond import smoothers as jsm
from conjugategradient_tpu.precond import transfer as jtr
from conjugategradient_tpu_torch.convert import hierarchy_from_reference
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle as tor
from conjugategradient_tpu_torch.ops.stencil import spmv_const_stencil
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.precond import smoothers as tsm
from conjugategradient_tpu_torch.precond import transfer as ttr


def _jax_fields(hj):
    """The JAX hierarchy as plain numpy arrays and Python values."""
    levels = [
        dict(coeffs=l.A.coeffs, shifts=l.A.shifts, grid=l.grid, cheb_bounds=l.cheb_bounds,
             transfer=l.transfer, inv_diag=np.asarray(l.inv_diag))
        for l in hj.levels
    ]
    return dict(levels=levels, coarse_inv=np.asarray(hj.coarse_inv), smoother=hj.smoother,
                pre=hj.pre, post=hj.post, omega=hj.omega)


def _build_both(grid, dtype=np.float64):
    sj = jgen.poisson_system(grid, dtype=dtype)
    st = tgen.poisson_system(grid, dtype=dtype)
    kw = dict(smoother="chebyshev", pre=2, post=2, dtype=dtype)
    hj = jmg.build_hierarchy(sj.A, grid, coarse_operator=jgen.poisson_coarse_operator(dtype), **kw)
    ht = tmg.build_hierarchy(st.A, grid, coarse_operator=tgen.poisson_coarse_operator(dtype), **kw)
    return hj, ht


@pytest.mark.parametrize("grid", [(33,), (31, 17), (9, 7, 5)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_generators_bit_identical(grid, dtype):
    sj = jgen.poisson_system(grid, seed=3, dtype=dtype)
    st = tgen.poisson_system(grid, seed=3, dtype=dtype)
    assert st.A.offsets == sj.A.offsets and st.A.shape == sj.A.shape
    np.testing.assert_array_equal(st.A.data, np.asarray(sj.A.data))
    np.testing.assert_array_equal(st.b, sj.b)
    np.testing.assert_array_equal(st.x0, sj.x0)
    coarse = tuple((n - 1) // 2 for n in grid)
    cj = jgen.poisson_coarse_operator(dtype)(2, coarse)
    ct = tgen.poisson_coarse_operator(dtype)(2, coarse)
    assert ct.offsets == cj.offsets and ct.data.dtype == np.asarray(cj.data).dtype
    np.testing.assert_array_equal(ct.data, np.asarray(cj.data))


@pytest.mark.parametrize("grid", [(31, 17), (9, 7, 5)])
def test_format_conversions_match_jax(grid):
    sj = jgen.poisson_system(grid)
    st = tgen.poisson_system(grid)
    stj, stt = jfmt.dia_to_stencil(sj.A, grid), tfmt.dia_to_stencil(st.A, grid)
    assert stt.shifts == stj.shifts and stt.grid == stj.grid
    np.testing.assert_array_equal(stt.data, np.asarray(stj.data))
    cj, ct = jfmt.stencil_to_const(stj), tfmt.stencil_to_const(stt)
    assert (ct.coeffs, ct.shifts, ct.grid) == (cj.coeffs, cj.shifts, cj.grid)
    assert ct.halo == cj.halo and ct.nnz == cj.nnz == stt.nnz
    np.testing.assert_array_equal(tfmt.dia_diagonal(st.A), jfmt.dia_diagonal(sj.A))
    np.testing.assert_array_equal(tfmt.dia_to_dense(st.A).data, np.asarray(jfmt.dia_to_dense(sj.A).data))
    for off in (1, -1, grid[-1], -grid[-1], grid[-1] + 1, 7 * grid[-1] - 3):
        assert tfmt._decompose_offset(off, grid) == jfmt._decompose_offset(off, grid)
    x = np.random.default_rng(0).standard_normal(st.n)
    np.testing.assert_array_equal(tor.spmv(st.A, x), jor.spmv(sj.A, x))
    # a variable-coefficient stencil is not const-representable
    legs = stt.data.copy()
    legs[0].flat[-1] = 5.0
    assert tfmt.stencil_to_const(tfmt.StencilMatrix(legs, stt.shifts, stt.grid)) is None


@pytest.mark.parametrize("grid", [(63, 63), (31, 31, 31), (63, 63, 63)])
def test_build_hierarchy_matches_jax(grid):
    # equal grids, coeffs, shifts, bounds, transfer kinds; exact inv_diag;
    # coarse_inv within 1e-12 (the same numpy code: in practice exact)
    hj, ht = _build_both(grid)
    hc = hierarchy_from_reference(**_jax_fields(hj))
    assert len(ht.levels) == len(hj.levels) == len(hc.levels) > 0
    for lt, lc in zip(ht.levels, hc.levels):
        assert lt.grid == lc.grid
        assert (lt.A.coeffs, lt.A.shifts, lt.A.grid) == (lc.A.coeffs, lc.A.shifts, lc.A.grid)
        assert lt.cheb_bounds == lc.cheb_bounds and lt.transfer == lc.transfer == "fw"
        assert lt.inv_diag.dtype == lc.inv_diag.dtype and lt.inv_diag.ndim == 0
        assert torch.equal(lt.inv_diag, lc.inv_diag)
    assert (ht.smoother, ht.pre, ht.post, ht.omega) == (hc.smoother, hc.pre, hc.post, hc.omega)
    np.testing.assert_allclose(ht.coarse_inv.numpy(), hc.coarse_inv.numpy(), rtol=0, atol=1e-12)


def test_hierarchy_is_a_module_with_buffers():
    _, ht = _build_both((31, 31, 31), np.float32)
    names = {n for n, _ in ht.named_buffers()}
    assert names == {"coarse_inv", "levels.0.inv_diag", "levels.1.inv_diag"}
    h64 = ht.to(torch.float64)
    assert h64.coarse_inv.dtype == torch.float64 and h64.levels[1].inv_diag.dtype == torch.float64


@pytest.mark.parametrize("grid", [(15, 31), (7, 9, 11)])
def test_transfers_match_jax(grid):
    rng = np.random.default_rng(1)
    v = rng.standard_normal(grid)
    rj = np.asarray(jtr.restrict_grid(jnp.asarray(v)))
    rt = ttr.restrict_grid(torch.from_numpy(v))
    assert rt.is_contiguous()
    np.testing.assert_allclose(rt.numpy(), rj, rtol=1e-12, atol=1e-12)
    e = rng.standard_normal(ttr.coarse_shape(grid))
    pj = np.asarray(jtr.prolong_grid(jnp.asarray(e), grid))
    pt = ttr.prolong_grid(torch.from_numpy(e), grid)
    assert pt.is_contiguous()
    np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-12, atol=1e-12)
    assert ttr.coarse_shape(grid) == jtr.coarse_shape(grid)
    assert ttr.can_coarsen((8, 9)) == jtr.can_coarsen((8, 9)) is False


@pytest.mark.parametrize("smoother", ["chebyshev", "jacobi"])
def test_smoothers_match_jax(smoother):
    grid = (13, 11, 9)
    jA = jfmt.stencil_to_const(jfmt.dia_to_stencil(jgen.poisson_system(grid).A, grid))
    tA = tfmt.stencil_to_const(tfmt.dia_to_stencil(tgen.poisson_system(grid).A, grid))
    rng = np.random.default_rng(2)
    b, x = rng.standard_normal((2,) + grid)
    invd = 1.0 / 6.0
    jop, top = partial(j_spmv_const, jA), partial(spmv_const_stencil, tA)
    if smoother == "chebyshev":
        xj = jsm.chebyshev_smooth(jop, jnp.asarray(invd), jnp.asarray(b), jnp.asarray(x), 3, 2.0, 0.5)
        xt = tsm.chebyshev_smooth(top, torch.tensor(invd, dtype=torch.float64), torch.from_numpy(b),
                                  torch.from_numpy(x), 3, 2.0, 0.5)
    else:
        xj = jsm.jacobi_smooth(jop, jnp.asarray(invd), jnp.asarray(b), jnp.asarray(x), 3)
        xt = tsm.jacobi_smooth(top, torch.tensor(invd, dtype=torch.float64), torch.from_numpy(b),
                               torch.from_numpy(x), 3)
    np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("grid", [(31, 31), (15, 15, 15)])
def test_v_cycle_matches_jax_fp64(grid):
    # same state in both packages (carried across); fp64 takes the unfused
    # path in both, so the cycles agree to rounding
    hj, _ = _build_both(grid)
    hc = hierarchy_from_reference(**_jax_fields(hj))
    b = np.random.default_rng(4).standard_normal(grid)
    yj = np.asarray(jmg.v_cycle(hj, jnp.asarray(b)))
    yt = tmg.v_cycle(hc, torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(yt, yj, rtol=1e-12, atol=1e-12)
    # flat input comes back flat
    yf = tmg.v_cycle(hc, torch.from_numpy(b.reshape(-1)))
    assert yf.shape == (b.size,)
    np.testing.assert_allclose(yf.numpy(), yj.reshape(-1), rtol=1e-12, atol=1e-12)


def test_fused_gate():
    _, h3 = _build_both((15, 15, 15), np.float32)
    _, h2 = _build_both((63, 63), np.float32)
    b3 = torch.zeros((15, 15, 15))
    assert tmg._fused_cheb_ok(h3.levels[0], b3)
    assert not tmg._fused_cheb_ok(h3.levels[0], b3.double())  # fp64 runs unfused
    assert not tmg._fused_cheb_ok(h2.levels[0], torch.zeros((63, 63)))  # 2-D runs unfused


def _anisotropic(grid, eps=1e-3):
    """2-D Poisson with the axis-0 coupling scaled by ``eps`` (semicoarsening
    territory), as a host DIA matrix of the given package."""
    A = tgen.poisson_system(grid).A
    data = np.array(A.data)
    ny, nx = grid
    for k, off in enumerate(A.offsets):
        if abs(off) == nx:
            data[k] *= eps
    data[A.offsets.index(0)] = 2.0 + 2.0 * eps
    return data, A.offsets, A.shape


def test_unported_branches_raise_naming_the_roadmap():
    # every branch this test once pinned as a refusal is ported: each call
    # now gives the JAX package's result
    s = tgen.poisson_system((15, 15))
    co, jco = tgen.poisson_coarse_operator(), jgen.poisson_coarse_operator()
    b = np.random.default_rng(8).standard_normal((15, 15))

    def same(ht, hj):
        assert [(l.grid, l.transfer) for l in ht.levels] == [(l.grid, l.transfer) for l in hj.levels]
        for lt, lj in zip(ht.levels, hj.levels):
            np.testing.assert_array_equal(lt.inv_diag.numpy(), np.asarray(lj.inv_diag))
        np.testing.assert_array_equal(ht.coarse_inv.numpy(), np.asarray(hj.coarse_inv))

    # Galerkin where the JAX package semicoarsens
    data, offsets, shape = _anisotropic((31, 63))
    hj = jmg.build_hierarchy(jfmt.DiaMatrix(data, offsets, shape), (31, 63))
    assert hj.levels[0].transfer == "semi01"
    same(tmg.build_hierarchy(tfmt.DiaMatrix(data, offsets, shape), (31, 63), device="cpu"), hj)
    # the (+1, 2, +1) tridiagonal's near-null vector alternates: aggregation
    hj = jmg.build_hierarchy(jgen.tridiagonal_matrix(2047), (2047,))
    assert hj.levels[0].transfer == "agg"
    ht = tmg.build_hierarchy(tgen.tridiagonal_matrix(2047), (2047,), device="cpu")
    same(ht, hj)
    np.testing.assert_array_equal(ht.levels[0].weight.numpy(), np.asarray(hj.levels[0].weight))
    # the rbgs smoother and fmg
    kw = dict(smoother="rbgs", max_coarse=63)
    ht = tmg.build_hierarchy(s.A, (15, 15), coarse_operator=co, device="cpu", **kw)
    hj = jmg.build_hierarchy(jgen.poisson_system((15, 15)).A, (15, 15), coarse_operator=jco, **kw)
    same(ht, hj)
    np.testing.assert_array_equal(ht.levels[0].mask.numpy(), np.asarray(hj.levels[0].mask))
    np.testing.assert_allclose(tmg.fmg(ht, torch.from_numpy(b)).numpy(),
                               np.asarray(jmg.fmg(hj, jnp.asarray(b))), rtol=1e-12, atol=1e-12)
    # a rediscretized even grid: hybrid transfers
    s64 = tgen.poisson_system((64, 64))
    ht = tmg.build_hierarchy(s64.A, (64, 64), coarse_operator=co, device="cpu")
    hj = jmg.build_hierarchy(jgen.poisson_system((64, 64)).A, (64, 64), coarse_operator=jco)
    assert ht.levels[0].transfer == "hyb"
    same(ht, hj)
    # an agg level carried across
    hj = jmg.build_hierarchy(jgen.tridiagonal_matrix(2047), (2047,))
    lj = hj.levels[0]
    hc = hierarchy_from_reference(
        [dict(coeffs=lj.A.coeffs, shifts=lj.A.shifts, grid=lj.grid, cheb_bounds=lj.cheb_bounds,
              transfer=lj.transfer, inv_diag=np.asarray(lj.inv_diag), weight=np.asarray(lj.weight),
              sa_smooth=lj.sa_smooth)]
        + [dict(legs=np.asarray(l.A.data), shifts=l.A.shifts, grid=l.grid,
                cheb_bounds=l.cheb_bounds, transfer=l.transfer, inv_diag=np.asarray(l.inv_diag))
           for l in hj.levels[1:]],
        np.asarray(hj.coarse_inv), hj.smoother, hj.pre, hj.post, hj.omega, device="cpu",
    )
    r = np.random.default_rng(9).standard_normal(2047)
    np.testing.assert_allclose(tmg.v_cycle(hc, torch.from_numpy(r)).numpy(),
                               np.asarray(jmg.v_cycle(hj, jnp.asarray(r))), rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="unknown smoother"):
        tmg.build_hierarchy(s.A, (15, 15), smoother="sor", coarse_operator=co)


def test_stencil_device_put_round_trips():
    grid = (5, 7, 3)
    st = tfmt.dia_to_stencil(tgen.diffusion_system(grid).A, grid)
    d = st.device_put()
    assert torch.is_tensor(d.data) and d.data.dtype == torch.float64
    assert np.shares_memory(d.data.numpy(), st.data)  # same dtype on the CPU: no copy
    assert (d.shifts, d.grid, d.nlegs, d.halo) == (st.shifts, st.grid, st.nlegs, st.halo)
    f = st.device_put(np.float32)
    assert f.data.dtype == torch.float32 and f.data.is_contiguous()
    np.testing.assert_array_equal(f.data.numpy(), st.data.astype(np.float32))
    b = d.astype(torch.bfloat16)
    assert b.data.dtype == torch.bfloat16 and b.device_put(torch.float64).data.dtype == torch.float64
    np.testing.assert_array_equal(st.astype(np.float32).data, f.data.numpy())
    np.testing.assert_array_equal(f.device_put(np.float64).data.numpy(),
                                  st.data.astype(np.float32).astype(np.float64))


def test_variable_levels_carry_across_and_move_with_the_module():
    # a Galerkin jump hierarchy, JAX fields -> hierarchy_from_reference ->
    # equal to the port's own build; the legs are a buffer, so a dtype cast
    # of the module moves the operator with it
    grid = (31, 31, 31)
    sj = jgen.diffusion_system(grid, contrast=1e4)
    hj = jmg.build_hierarchy(sj.A, grid, dtype=np.float32)
    levels = [dict(legs=np.asarray(l.A.data), shifts=l.A.shifts, grid=l.grid,
                   cheb_bounds=l.cheb_bounds, transfer=l.transfer, inv_diag=np.asarray(l.inv_diag))
              for l in hj.levels]
    hc = hierarchy_from_reference(levels, np.asarray(hj.coarse_inv), hj.smoother, hj.pre,
                                  hj.post, hj.omega)
    ht = tmg.build_hierarchy(tgen.diffusion_system(grid, contrast=1e4).A, grid, dtype=np.float32)
    for lc, lt in zip(hc.levels, ht.levels):
        assert isinstance(lc.A, tfmt.StencilMatrix) and lc.A.data.dtype == torch.float32
        assert lc.A.shifts == lt.A.shifts and lc.cheb_bounds == lt.cheb_bounds
        assert torch.equal(lc.A.data, lt.A.data) and torch.equal(lc.inv_diag, lt.inv_diag)
    assert [l.A.nlegs for l in hc.levels] == [7, 27]
    h64 = hc.to(torch.float64)
    assert all(l.A.data.dtype == l.inv_diag.dtype == torch.float64 for l in h64.levels)
    with pytest.raises(ValueError, match="not grid"):
        hierarchy_from_reference([dict(levels[0], inv_diag=np.asarray(1.0))],
                                 np.eye(1), "chebyshev", 2, 2, 2 / 3)
