"""The multi-RHS grid path on the CPU against the JAX package.

``spmm_stencil``/``spmm_const_stencil`` hold to the JAX package's (fp64, the
same leg order); multi-RHS MGCG (``cg_solve_multi`` with
``as_multi_preconditioner``), the ``(n, k)`` ``mgcg`` facade and
``refined_solve_multi(grid=)`` take the JAX package's per-column iteration
counts on the same systems, whose host data the generators make
bit-identical.  On the CPU every stencil product runs the kernels' twins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.stencil import spmm_const_stencil as j_spmm_const
from conjugategradient_tpu.ops.stencil import spmm_stencil as j_spmm
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.multi import as_multi_preconditioner as j_as_multi
from conjugategradient_tpu.solvers.multi import cg_solve_multi as j_cg_multi
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu.solvers.refine import refined_solve_multi as j_refined_multi
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops.spmv import spmv
from conjugategradient_tpu_torch.ops.stencil import spmm_columns, spmm_const_stencil, spmm_stencil
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner, cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi

K = 4


def _rhs(n, k=K, seed=3):
    return np.random.default_rng(seed).standard_normal((n, k))


def _systems(kind, grid):
    """(port system, JAX system) of ``kind`` on ``grid``: bit-identical host
    data."""
    if kind == "poisson":
        return tgen.poisson_system(grid), jgen.poisson_system(grid)
    kw = dict(kind=kind, contrast=1e3, seed=0)
    return tgen.diffusion_system(grid, **kw), jgen.diffusion_system(grid, **kw)


@pytest.mark.parametrize("grid", [(9, 9), (7, 7, 7)])
@pytest.mark.parametrize("kind", ["poisson", "jump"])
def test_spmm_stencil_matches_jax_fp64(kind, grid):
    st, sj = _systems(kind, grid)
    At = dia_to_stencil(st.A, grid).device_put(device="cpu")
    Aj = jfmt.dia_to_stencil(sj.A, grid).device_put()
    n = st.n
    B = _rhs(n)
    ref = np.asarray(j_spmm(Aj, jnp.asarray(B)))
    for Bt, back in ((torch.from_numpy(B), lambda Y: Y),
                     (torch.from_numpy(B.reshape(grid + (K,))), lambda Y: Y.reshape(n, K))):
        Y = back(spmm_stencil(At, Bt)).numpy()
        np.testing.assert_allclose(Y, ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max())
    if kind == "poisson":
        Ct, Cj = stencil_to_const(At), jfmt.stencil_to_const(Aj)
        ref = np.asarray(j_spmm_const(Cj, jnp.asarray(B)))
        Y = spmm_const_stencil(Ct, torch.from_numpy(B)).numpy()
        np.testing.assert_allclose(Y, ref, rtol=1e-14, atol=1e-14 * np.abs(ref).max())


@pytest.mark.parametrize("legs", [torch.float64, torch.bfloat16])
def test_spmm_columns_is_the_spmv_of_each_column(legs):
    grid = (7, 6, 5)
    st = tgen.diffusion_system(grid, contrast=1e3)
    A = dia_to_stencil(st.A, grid).device_put(legs, "cpu")
    vec = torch.float64 if legs == torch.float64 else torch.float32
    X = torch.from_numpy(_rhs(st.n).T.copy()).to(vec)  # (k, n), the solver's layout
    Y = spmm_columns(A, X)
    assert Y.shape == X.shape and Y.dtype == vec
    for j in range(K):
        assert torch.equal(Y[j], spmv(A, X[j]))
    with pytest.raises(ValueError, match="not compatible"):
        spmm_stencil(A, X[:, :-1])


MG_CASES = {"poisson 63^2": ("poisson", (63, 63)), "jump 15^3": ("jump", (15, 15, 15))}


@pytest.mark.parametrize("case", sorted(MG_CASES))
def test_multi_mgcg_matches_jax_fp64(case):
    kind, grid = MG_CASES[case]
    st, sj = _systems(kind, grid)
    B = _rhs(st.n)
    B[:, 3] *= 1e-3  # a column that starts far smaller
    ht, hj = tmg.build_hierarchy(st.A, grid, device="cpu"), jmg.build_hierarchy(sj.A, grid)
    assert len(ht.levels) == len(hj.levels) > 0
    pol = dict(tol=1e-8, norm="rel_l2", max_iteration=500)
    rt = cg_solve_multi(st.A.device_put(device="cpu"), torch.from_numpy(B),
                        policy=ConvergencePolicy(**pol), M=as_multi_preconditioner(ht))
    j_solve = jax.jit(lambda A, B: j_cg_multi(A, B, policy=JPolicy(**pol), M=j_as_multi(hj)))
    rj = j_solve(sj.A.device_put(), jnp.asarray(B))
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    Xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), Xj, rtol=1e-10, atol=1e-10 * np.abs(Xj).max())


def test_multi_preconditioner_is_the_v_cycle_of_each_column():
    grid = (15, 15, 15)
    st = tgen.diffusion_system(grid, contrast=1e3)
    h = tmg.build_hierarchy(st.A, grid, dtype=np.float32, device="cpu")
    R = torch.from_numpy(_rhs(st.n).astype(np.float32))
    Z = as_multi_preconditioner(h)(R)
    assert Z.shape == R.shape
    for j in range(K):
        assert torch.equal(Z[:, j], tmg.v_cycle(h, R[:, j].contiguous()))


def test_multi_rhs_mgcg_beats_independent_on_matrix_passes():
    # the JAX package's tests/test_multi.py inequality: k recurrences sharing
    # one matrix stream per iteration take fewer matrix passes (max over
    # columns) than k independent MGCG solves (sum over columns), and MGCG
    # fewer than plain multi-RHS CG
    grid = (63, 63)
    system = tgen.poisson_system(grid)
    B = np.random.default_rng(3).standard_normal((system.n, K))
    pol = ConvergencePolicy(tol=1e-8, norm="rel_l2", max_iteration=500)
    h = tmg.build_hierarchy(system.A, grid, device="cpu")
    A = system.A.device_put(device="cpu")
    res = cg_solve_multi(A, torch.from_numpy(B), policy=pol, M=as_multi_preconditioner(h))
    assert bool(res.converged.all())
    X = res.x.numpy()
    for j in range(K):
        r = B[:, j] - oracle.spmv(system.A, X[:, j])
        assert np.linalg.norm(r) / np.linalg.norm(B[:, j]) < 1e-6
    multi_passes = int(res.iterations.max())
    M = tmg.as_preconditioner(h)
    indep_passes = 0
    for j in range(K):
        rj = cg_solve(h.levels[0].A, torch.from_numpy(B[:, j]).reshape(grid), policy=pol, M=M)
        assert rj.converged
        indep_passes += rj.iterations
    assert multi_passes < indep_passes, (multi_passes, indep_passes)
    plain = cg_solve_multi(A, torch.from_numpy(B), policy=pol)
    assert multi_passes < int(plain.iterations.max())


def test_multi_mgcg_on_the_stencil_operator_matches_dia():
    grid = (15, 15, 15)
    st = tgen.diffusion_system(grid, contrast=1e3)
    h = tmg.build_hierarchy(st.A, grid, device="cpu")
    B = torch.from_numpy(_rhs(st.n))
    pol = ConvergencePolicy(tol=1e-8, norm="rel_l2")
    M = as_multi_preconditioner(h)
    on_dia = cg_solve_multi(st.A.device_put(device="cpu"), B, policy=pol, M=M)
    on_stencil = cg_solve_multi(h.levels[0].A, B, policy=pol, M=M)
    assert torch.equal(on_dia.iterations, on_stencil.iterations)
    np.testing.assert_allclose(on_stencil.x.numpy(), on_dia.x.numpy(), rtol=1e-12, atol=1e-14)


def test_facade_multi_mgcg_matches_jax():
    # one case: the JAX facade runs its multi-RHS solve op by op (no jit)
    kind, grid = MG_CASES["jump 15^3"]
    st, sj = _systems(kind, grid)
    B = _rhs(st.n, seed=5)
    kw = dict(method="mgcg", grid=grid, tol=1e-8, norm="rel_l2")
    rt = api.solve(st.A, B, device="cpu", **kw)
    rj = japi.solve(sj.A, B, **kw)
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    Xj = np.asarray(rj.x)
    np.testing.assert_allclose(rt.x.numpy(), Xj, rtol=1e-10, atol=1e-10 * np.abs(Xj).max())
    with pytest.raises(ValueError, match="grid"):
        api.solve(st.A, B, method="mgcg", device="cpu")


@pytest.mark.parametrize("max_coarse", [255, 1025])
def test_refined_multi_grid_matches_jax_and_single_columns(max_coarse):
    # max_coarse 255 keeps one Galerkin level (31^2) over a 15^2 dense solve;
    # 1025 leaves no level (the dense inverse of the whole 31^2 system).
    # fp64 inner solves: the two packages' inner counts are then equal
    grid = (31, 31)
    st, sj = _systems("jump", grid)
    kw = dict(smoother="chebyshev", pre=2, post=2, dtype=np.float64, max_coarse=max_coarse)
    ht = tmg.build_hierarchy(st.A, grid, device="cpu", **kw)
    hj = jmg.build_hierarchy(sj.A, grid, **kw)
    assert len(ht.levels) == len(hj.levels) == (1 if max_coarse == 255 else 0)
    B = _rhs(st.n, 3)
    rkw = dict(tol=1e-10, norm="l2", grid=grid, inner_tol=1e-4, device_dtype=np.float64)
    rt = refined_solve_multi(st.A, B, hierarchy=ht, device="cpu", **rkw)
    rj = j_refined_multi(sj.A, B, hierarchy=hj, **rkw)
    assert rt.converged.all() and np.asarray(rj.converged).all() and not rt.stalled.any()
    assert rt.outer_iterations == rj.outer_iterations
    np.testing.assert_array_equal(rt.inner_iterations, np.asarray(rj.inner_iterations))
    for j in range(3):
        assert np.linalg.norm(B[:, j] - oracle.spmv(st.A, rt.x[:, j])) < 1e-10
        single = refined_solve(st.A, B[:, j], hierarchy=ht, device="cpu", **rkw)
        np.testing.assert_allclose(rt.x[:, j], single.x, rtol=1e-8, atol=1e-11)


def test_refined_multi_grid_bf16_legs_and_facade():
    # bf16 legs on the variable fine operator: the inner solves converge on
    # the rounded operator, the fp64 outer passes correct for it
    grid = (31, 31)
    st, sj = _systems("smooth", grid)
    B = _rhs(st.n, 2)
    kw = dict(tol=1e-9, norm="l2", grid=grid, inner_tol=1e-4)
    rt = refined_solve_multi(st.A, B, matrix_dtype=torch.bfloat16, device="cpu", **kw)
    rj = j_refined_multi(sj.A, B, matrix_dtype=jnp.bfloat16, **kw)
    assert rt.converged.all() and np.asarray(rj.converged).all()
    # legs round the same up to one bf16 ulp: the pass counts agree within one
    assert abs(rt.outer_iterations - rj.outer_iterations) <= 1
    for j in range(2):
        assert np.linalg.norm(B[:, j] - oracle.spmv(st.A, rt.x[:, j])) < 1e-9
    fa = api.solve(st.A, B, method="refined", device="cpu", **kw)
    assert fa.converged.all()
    np.testing.assert_allclose(fa.x, refined_solve_multi(st.A, B, device="cpu", **kw).x)
