"""The flagship banded path on the CPU: the port's ``refined_solve`` and
``refined_solve_multi`` against the JAX package's, on the same systems.

On the CPU the port's inner CG runs the DIA kernel's twin and the JAX
package's the XLA ``spmv_dia`` (its default off the TPU); both are fp32 with
compensated dots under an fp64 outer loop, so the outer pass counts agree
and the fp64 solutions agree to far below fp32 rounding.  The port's device
residual is native fp64, the JAX package's double-float: both converge.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import oracle as joracle
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.refine import refined_solve as j_refined
from conjugategradient_tpu.solvers.refine import refined_solve_multi as j_refined_multi
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers.policy import NotConvergedError
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi


def _true_l2(sys_, x):
    return np.linalg.norm(sys_.b - oracle.spmv(sys_.A, x))


def _block_rhs(n, k, seed=3):
    return np.random.default_rng(seed).standard_normal((n, k))


def test_flagship_contract_matches_jax_and_oracle():
    # absolute 1e-8 on ||r||_2 with fp32 inner solves (the reference's contract)
    st, sj = tgen.banded_sin_system(4096, 32), jgen.banded_sin_system(4096, 32)
    kw = dict(tol=1e-8, norm="l2", device_dtype=np.float32, inner_tol=1e-4)
    rt = refined_solve(st.A, st.b, st.x0, **kw)
    rj = j_refined(sj.A, sj.b, sj.x0, **kw)
    assert rt.converged and rj.converged
    assert rt.outer_iterations == rj.outer_iterations
    assert abs(rt.inner_iterations - rj.inner_iterations) <= rt.outer_iterations
    ref = oracle.cg(st.A, st.b, st.x0, tol=1e-8)
    np.testing.assert_allclose(rt.x, ref.x, rtol=1e-6, atol=1e-9)
    assert _true_l2(st, rt.x) < 1e-8
    assert set(rt.timings) == {"inner_s", "outer_s"}


def test_plain_inner_tridiagonal():
    st, sj = tgen.tridiagonal_system(1023), jgen.tridiagonal_system(1023)
    rt = refined_solve(st.A, st.b, tol=1e-8, device_dtype=np.float32, inner_tol=1e-4)
    rj = j_refined(sj.A, sj.b, tol=1e-8, device_dtype=np.float32, inner_tol=1e-4)
    assert rt.converged and rj.converged and rt.outer_iterations == rj.outer_iterations
    assert _true_l2(st, rt.x) < 1e-8
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9, atol=1e-6)


def test_bf16_matrix_stream():
    """bf16 legs with fp32 accumulation: the inner CG converges on the
    rounded operator and the fp64 outer passes correct for it."""
    st, sj = tgen.banded_sin_system(4096, 32), jgen.banded_sin_system(4096, 32)
    rt = refined_solve(st.A, st.b, st.x0, tol=1e-8, norm="l2", matrix_dtype=torch.bfloat16)
    rj = j_refined(sj.A, sj.b, sj.x0, tol=1e-8, norm="l2", matrix_dtype=jnp.bfloat16)
    assert rt.converged and rj.converged
    # legs round the same up to one bf16 ulp: the pass counts agree within one
    assert abs(rt.outer_iterations - rj.outer_iterations) <= 1
    assert _true_l2(st, rt.x) < 1e-8


def test_device_residual_fp64_matches_jax_double_float():
    st, sj = tgen.banded_sin_system(4096, 16), jgen.banded_sin_system(4096, 16)
    rt = refined_solve(st.A, st.b, tol=1e-8, device_residual=True)
    rj = j_refined(sj.A, sj.b, tol=1e-8, device_residual=True, use_pallas=False)
    assert rt.converged and rj.converged
    assert _true_l2(st, rt.x) < 1e-8
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-8, atol=1e-10)
    host = refined_solve(st.A, st.b, tol=1e-8)
    assert host.outer_iterations == rt.outer_iterations
    assert {"input_s", "exec_s", "output_s", "inner_s", "outer_s"} <= set(rt.timings)


def test_device_residual_x0_and_linf():
    s = tgen.banded_sin_system(1024, 8)
    res = refined_solve(s.A, s.b, x0=s.x0, tol=1e-7, norm="linf", device_residual=True)
    assert res.converged
    assert np.abs(s.b - oracle.spmv(s.A, res.x)).max() < 1e-7


def test_device_residual_rejects_fp64_state():
    s = tgen.tridiagonal_system(63)
    with pytest.raises(ValueError, match="float32"):
        refined_solve(s.A, s.b, device_residual=True, device_dtype=np.float64)


def test_divergence_flag():
    s = tgen.tridiagonal_system(255)
    with pytest.raises(NotConvergedError):
        refined_solve(s.A, s.b, tol=1e-300, max_outer=2, raise_on_divergence=True)
    res = refined_solve(s.A, s.b, tol=1e-300, max_outer=2)
    assert not res.converged and res.outer_iterations == 2


@pytest.mark.parametrize("device_residual", [False, True])
def test_unreachable_tolerance_terminates(device_residual):
    # below the fp64 floor: must stall, exhaust max_outer, or hit an exactly
    # zero residual, never loop or falsely claim convergence
    s = tgen.tridiagonal_system(255)
    res = refined_solve(s.A, s.b, tol=1e-300, max_outer=8, device_residual=device_residual)
    assert res.outer_iterations <= 8
    if res.converged:
        assert res.residual == 0.0
    else:
        assert res.stalled or res.outer_iterations == 8


def test_multi_matches_single_columns_and_jax():
    st, sj = tgen.tridiagonal_system(511), jgen.tridiagonal_system(511)
    B = _block_rhs(st.n, 3)
    res = refined_solve_multi(st.A, B, tol=1e-9, inner_tol=1e-4)
    rj = j_refined_multi(sj.A, B, tol=1e-9, inner_tol=1e-4)
    assert res.converged.all() and rj.converged.all()
    assert res.outer_iterations == rj.outer_iterations
    for j in range(3):
        single = refined_solve(st.A, B[:, j], tol=1e-9, inner_tol=1e-4)
        np.testing.assert_allclose(res.x[:, j], single.x, rtol=1e-7, atol=1e-10)


def test_multi_freezes_converged_columns():
    # column 0's RHS is A e (solved in one pass); column 1 is random: the easy
    # column stops accumulating inner iterations while the hard one refines
    s = tgen.tridiagonal_system(255)
    e = np.zeros(s.n)
    e[7] = 1.0
    B = np.stack([oracle.spmv(s.A, e), _block_rhs(s.n, 1)[:, 0]], axis=1)
    res = refined_solve_multi(s.A, B, tol=1e-10, inner_tol=1e-2, max_outer=30)
    assert res.converged.all()
    assert res.inner_iterations[0] <= res.inner_iterations[1]
    np.testing.assert_allclose(res.x[:, 0], e, atol=1e-9)


def test_multi_max_outer_flags_nonconvergence():
    s = tgen.tridiagonal_system(127)
    res = refined_solve_multi(s.A, _block_rhs(s.n, 2), tol=1e-300, max_outer=2)
    assert not res.converged.any() and res.outer_iterations == 2


@pytest.mark.parametrize("device_residual", [False, True])
def test_grid_path_with_rediscretized_hierarchy_matches_jax(device_residual):
    # max_coarse below 31^2 keeps one fw level (31^2) over a 15^2 dense solve
    grid = (31, 31)
    st, sj = tgen.poisson_system(grid), jgen.poisson_system(grid)
    kw = dict(smoother="chebyshev", pre=2, post=2, dtype=np.float32, max_coarse=255)
    ht = tmg.build_hierarchy(st.A, grid, coarse_operator=tgen.poisson_coarse_operator(np.float32), **kw)
    hj = jmg.build_hierarchy(sj.A, grid, coarse_operator=jgen.poisson_coarse_operator(np.float32), **kw)
    rkw = dict(tol=1e-10, norm="rel_l2", grid=grid, device_residual=device_residual)
    rt = refined_solve(st.A, st.b, hierarchy=ht, **rkw)
    rj = j_refined(sj.A, sj.b, hierarchy=hj, **rkw)
    assert rt.converged and rj.converged
    assert rt.outer_iterations == rj.outer_iterations
    r = st.b - oracle.spmv(st.A, rt.x)
    assert np.linalg.norm(r) / np.linalg.norm(st.b) < 1e-10
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-8, atol=1e-12)


def test_unported_options_raise():
    s = tgen.poisson_system((31, 31))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 9"):
        refined_solve(s.A, s.b, grid=(31, 31))  # Galerkin hierarchy build
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        refined_solve(s.A, s.b, inner="bicgstab")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 10"):
        refined_solve(s.A, s.b, deflation=object())
    with pytest.raises(ValueError, match="unknown inner"):
        refined_solve(s.A, s.b, inner="gmres")
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 8"):
        refined_solve_multi(s.A, _block_rhs(s.n, 2), grid=(31, 31))


def test_oracle_cg_is_bit_identical_to_jax():
    st, sj = tgen.banded_sin_system(300, 8), jgen.banded_sin_system(300, 8)
    a = oracle.cg(st.A, st.b, st.x0, tol=1e-10, record_history=True)
    b = joracle.cg(sj.A, sj.b, sj.x0, tol=1e-10, record_history=True)
    assert a.iterations == b.iterations and a.history == b.history
    np.testing.assert_array_equal(a.x, b.x)
    with pytest.raises(oracle.NotConvergedError):
        oracle.cg(st.A, st.b, tol=1e-300, max_iteration=3)
