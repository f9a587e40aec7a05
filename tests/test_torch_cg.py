"""The port's BLAS-1, compensated dot, policy and CG against the JAX package,
on the CPU, with inputs made from a numpy seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.formats import dia_to_stencil as j_dia_to_stencil
from conjugategradient_tpu.core.formats import stencil_to_const as j_stencil_to_const
from conjugategradient_tpu.ops import blas as jblas
from conjugategradient_tpu.ops import precision as jprec
from conjugategradient_tpu.solvers.cg import cg_solve as j_cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops import blas as tblas
from conjugategradient_tpu_torch.ops import precision as tprec
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, NotConvergedError


def test_dot2_matches_jax_fp32():
    # positive entries: no cancellation, so both tree sums are within a few
    # fp32 ulps of the exact value; rtol 1e-6
    rng = np.random.default_rng(0)
    a = rng.random(100_003).astype(np.float32)
    b = rng.random(100_003).astype(np.float32)
    d_j = float(jprec.dot2(jnp.asarray(a), jnp.asarray(b)))
    d_t = float(tprec.dot2(torch.from_numpy(a), torch.from_numpy(b)))
    exact = float(np.dot(a.astype(np.float64), b.astype(np.float64)))
    np.testing.assert_allclose(d_t, d_j, rtol=1e-6)
    np.testing.assert_allclose(d_t, exact, rtol=1e-6)


def test_two_prod_is_error_free_fp32():
    # p + e == a * b exactly (checked in fp64, where the fp32 product is exact)
    rng = np.random.default_rng(1)
    a = rng.standard_normal(4096).astype(np.float32)
    b = rng.standard_normal(4096).astype(np.float32)
    p, e = tprec.two_prod(torch.from_numpy(a), torch.from_numpy(b))
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(p.double().numpy() + e.double().numpy(), exact)
    pj, ej = jprec.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(p.numpy(), np.asarray(pj))
    np.testing.assert_array_equal(e.numpy(), np.asarray(ej))


@pytest.mark.parametrize("norm", ["l2", "linf", "rel_l2"])
def test_residual_norm_matches_jax(norm):
    rng = np.random.default_rng(2)
    r = rng.standard_normal((31, 17))
    rr, rr0 = float(np.dot(r.ravel(), r.ravel())), 7.5
    f64 = dict(dtype=torch.float64)
    got = tblas.residual_norm(torch.from_numpy(r), torch.tensor(rr, **f64), torch.tensor(rr0, **f64), norm)
    want = jblas.residual_norm(jnp.asarray(r), jnp.asarray(rr), jnp.asarray(rr0), norm)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-14)


def test_blas_helpers_match_jax():
    rng = np.random.default_rng(3)
    a, b = rng.standard_normal((2, 9, 13))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    np.testing.assert_allclose(float(tblas.dot(ta, tb)), float(jblas.dot(ja, jb)), rtol=1e-13)
    np.testing.assert_allclose(
        float(tblas.dot(ta, tb, precise=True)), float(jblas.dot(ja, jb, precise=True)), rtol=1e-13
    )
    np.testing.assert_allclose(tblas.axpy(0.5, ta, tb).numpy(), np.asarray(jblas.axpy(0.5, ja, jb)))
    np.testing.assert_array_equal(tblas.scal(-3.0, ta).numpy(), np.asarray(jblas.scal(-3.0, ja)))
    assert float(tblas.max_abs(ta)) == float(jblas.max_abs(ja))
    np.testing.assert_allclose(float(tblas.norm_l2(ta)), float(jblas.norm_l2(ja)), rtol=1e-14)


def test_policy_resolve_max_clamps_like_jax():
    for m in (None, 10, 8 * 347_000_000):
        assert ConvergencePolicy(max_iteration=m).resolve_max(1000) == JPolicy(
            max_iteration=m
        ).resolve_max(1000)
    assert ConvergencePolicy(max_iteration=8 * 347_000_000).resolve_max(1) == 2**31 - 1
    with pytest.raises(ValueError):
        ConvergencePolicy(tol=0.0)
    with pytest.raises(ValueError):
        ConvergencePolicy(min_iteration=5, max_iteration=2)


def _poisson_2d(grid=(63, 63)):
    sj = jgen.poisson_system(grid, dtype=np.float64)
    st = tgen.poisson_system(grid, dtype=np.float64)
    np.testing.assert_array_equal(sj.b, st.b)
    jA = j_stencil_to_const(j_dia_to_stencil(sj.A, grid))
    tA = stencil_to_const(dia_to_stencil(st.A, grid))
    return jA, tA, sj.b.reshape(grid)


def test_plain_cg_matches_jax_63sq_fp64():
    # equal iteration count; x within 1e-10 relative (the same recurrence in
    # fp64, reductions in a different order)
    jA, tA, b = _poisson_2d()
    pol = dict(tol=1e-8, norm="rel_l2")
    rj = j_cg_solve(jA, jnp.asarray(b), policy=JPolicy(**pol))
    rt = cg_solve(tA, torch.from_numpy(b), policy=ConvergencePolicy(**pol))
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() / np.abs(xj).max() < 1e-10


@pytest.mark.parametrize(
    "pol",
    [
        dict(tol=1e-8, norm="linf", max_iteration=7),  # stops at the cap, not converged
        dict(tol=1e-1, norm="l2", min_iteration=9),  # min_iteration is inclusive
        dict(tol=1e-6, norm="rel_l2", min_iteration=0, max_iteration=0),  # no iteration at all
    ],
)
def test_cg_policy_edges_match_jax(pol):
    jA, tA, b = _poisson_2d((15, 15))
    rj = j_cg_solve(jA, jnp.asarray(b), policy=JPolicy(**pol), precise_dot=True)
    rt = cg_solve(tA, torch.from_numpy(b), policy=ConvergencePolicy(**pol), precise_dot=True)
    assert rt.iterations == int(rj.iterations)
    assert rt.converged == bool(rj.converged)
    np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-10)
    if not rt.converged:
        with pytest.raises(NotConvergedError):
            rt.raise_if_diverged()


def test_cg_exact_guess_stays_finite_under_min_iteration():
    # b = 0 from x0 = 0: r = 0 exactly, and min_iteration forces sweeps that
    # would divide 0 by 0 without _safe_div
    _, tA, b = _poisson_2d((15, 15))
    zero = torch.zeros(b.shape, dtype=torch.float64)
    r = cg_solve(tA, zero, policy=ConvergencePolicy(tol=1.0, norm="l2", min_iteration=3))
    assert r.iterations == 3 and r.converged
    assert bool((r.x == 0).all())
