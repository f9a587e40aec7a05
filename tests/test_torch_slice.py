"""The whole slice on the CPU: MGCG on the Poisson problem through the port's
entry points against the JAX package's, on the same systems.

fp64 runs the unfused V-cycle in both packages, so the iteration counts are
equal and the solutions agree to rounding.  In fp32 the port's 3-D levels
take the fused Chebyshev path (the kernel's twin on the CPU) while the JAX
package on the CPU runs unfused: both converge, and the iteration counts
differ by at most one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.cg import cg_solve as j_cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.convert import hierarchy_from_reference
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _solve_both(grid, dtype, tol):
    sj = jgen.poisson_system(grid, dtype=dtype)
    st = tgen.poisson_system(grid, dtype=dtype)
    kw = dict(smoother="chebyshev", pre=2, post=2, dtype=dtype)
    hj = jmg.build_hierarchy(sj.A, grid, coarse_operator=jgen.poisson_coarse_operator(dtype), **kw)
    ht = tmg.build_hierarchy(st.A, grid, coarse_operator=tgen.poisson_coarse_operator(dtype), **kw)
    pol = dict(tol=tol, norm="rel_l2", max_iteration=8 * st.n)
    rj = j_cg_solve(hj.levels[0].A, jnp.asarray(sj.b).reshape(grid), policy=JPolicy(**pol),
                    M=jmg.as_preconditioner(hj), precise_dot=True)
    rt = cg_solve(ht.levels[0].A, torch.from_numpy(st.b).reshape(grid),
                  policy=ConvergencePolicy(**pol), M=tmg.as_preconditioner(ht), precise_dot=True)
    return st, hj, ht, rj, rt


def _true_rel(system, x):
    A64 = system.A.astype(np.float64)
    b64 = system.b.astype(np.float64)
    r = b64 - oracle.spmv(A64, np.asarray(x, np.float64).reshape(-1))
    return np.linalg.norm(r) / np.linalg.norm(b64)


@pytest.mark.parametrize("grid, levels", [((63, 63), 1), ((31, 31, 31), 2)])
def test_mgcg_fp64_matches_jax(grid, levels):
    # equal iteration counts; x within 1e-9 relative
    st, hj, ht, rj, rt = _solve_both(grid, np.float64, 1e-8)
    assert len(ht.levels) == len(hj.levels) == levels
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() / np.abs(xj).max() < 1e-9
    assert _true_rel(st, rt.x.numpy()) < 1e-8


def test_mgcg_fp32_fused_twin_63cube():
    # the port's 3-D levels go through the fused smoother's twin, the JAX
    # package's through the unfused smoother: iterations within one, true
    # fp64 relative residual at the fp32 drift floor (1e-5)
    cuda_stencil.reset_launch_counts()
    st, hj, ht, rj, rt = _solve_both((63, 63, 63), np.float32, 1e-6)
    assert len(ht.levels) == 3
    assert rt.converged and bool(rj.converged)
    assert abs(rt.iterations - int(rj.iterations)) <= 1
    assert _true_rel(st, rt.x.numpy()) <= 1e-5
    assert _true_rel(st, np.asarray(rj.x)) <= 1e-5
    assert cuda_stencil.cheb_smooth_const_cuda.launches == 0  # twins on the CPU


def test_mgcg_same_state_and_entry_point():
    # the hierarchy carried across from the JAX build drives the same solve
    # to the same iteration count, through mgcg_solve
    grid = (31, 31, 31)
    sj = jgen.poisson_system(grid)
    hj = jmg.build_hierarchy(sj.A, grid, coarse_operator=jgen.poisson_coarse_operator())
    levels = [
        dict(coeffs=l.A.coeffs, shifts=l.A.shifts, grid=l.grid, cheb_bounds=l.cheb_bounds,
             transfer=l.transfer, inv_diag=np.asarray(l.inv_diag))
        for l in hj.levels
    ]
    hc = hierarchy_from_reference(levels, np.asarray(hj.coarse_inv), hj.smoother, hj.pre,
                                  hj.post, hj.omega)
    pol = dict(tol=1e-8, norm="rel_l2")
    rj, _ = jmg.mgcg_solve(sj.A, sj.b, grid, policy=JPolicy(**pol), hierarchy=hj)
    rt, h_used = tmg.mgcg_solve(sj.A, sj.b, grid, policy=ConvergencePolicy(**pol), hierarchy=hc)
    assert h_used is hc
    assert rt.x.shape == (sj.n,)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=0, atol=1e-9 * np.abs(rj.x).max())
    # and building inside mgcg_solve gives the same answer
    rb, hb = tmg.mgcg_solve(sj.A, sj.b, grid, policy=ConvergencePolicy(**pol),
                            coarse_operator=tgen.poisson_coarse_operator())
    assert rb.iterations == rt.iterations and len(hb.levels) == len(hc.levels)
