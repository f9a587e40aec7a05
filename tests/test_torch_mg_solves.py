"""MGCG over the hybrid, semicoarsening and aggregation hierarchies (and
the ``layout``, ``const_detect``, ``transfer_kind``, ``sa_smooth_levels``
and rbgs options) against the JAX package on the CPU in fp64: equal
iteration counts and solutions within 1e-10 relative.  W-cycles and fmg are
in ``test_torch_mg_cycles.py`` and the hierarchies themselves in
``test_torch_mg_kinds.py``, both over this file's cases; inputs are made from numpy seeds and handed
to both packages."""

import numpy as np
import pytest

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: (system, grid, build keywords)
SOLVES = {
    "poisson 32^3 (hyb, agg)": ("poisson", (32, 32, 32), {}),
    "poisson 64^2 (hyb)": ("poisson", (64, 64), {}),
    "tridiagonal 4096 (agg, hyb)": ("tridiagonal", (4096,), {}),
    "anisotropic 128^2 (semi)": ("aniso", (128, 128), {}),
    "anisotropic 31^3 (semi)": ("aniso", (31, 31, 31), {}),
    "transfer_kind agg 33^2": ("poisson", (33, 33), dict(transfer_kind="agg", max_coarse=63)),
    "sa_smooth_levels 1 agg 33^2": ("poisson", (33, 33),
                                    dict(transfer_kind="agg", sa_smooth_levels=1, max_coarse=63)),
    "const_detect off hyb 32^2": ("poisson", (32, 32),
                                  dict(transfer_kind="hyb", const_detect=False, max_coarse=63)),
    "layout dia 64^2": ("poisson", (64, 64), dict(layout="dia")),
    "smoother rbgs 64^2": ("poisson", (64, 64), dict(smoother="rbgs")),
}


def _systems(kind, grid):
    """(JAX, port) systems: Poisson, the (2, 1) tridiagonal, or anisotropic
    diffusion with the coupling of axis 0 (2-D) or axis 2 (3-D) at 1e-3."""
    if kind == "poisson":
        return jgen.poisson_system(grid), tgen.poisson_system(grid)
    if kind == "tridiagonal":
        return jgen.tridiagonal_system(grid[0]), tgen.tridiagonal_system(grid[0])
    ratios = (1e-3, 1.0) if len(grid) == 2 else (1.0, 1.0, 1e-3)
    return (jgen.anisotropic_diffusion_system(grid, ratios),
            tgen.anisotropic_diffusion_system(grid, ratios))


def _build(case):
    kind, grid, kw = SOLVES[case]
    sj, st = _systems(kind, grid)
    return sj, st, grid, jmg.build_hierarchy(sj.A, grid, **kw), tmg.build_hierarchy(
        st.A, grid, device="cpu", **kw)


def _close(xt, xj, rtol):
    xt, xj = np.asarray(xt), np.asarray(xj)
    assert np.abs(xt - xj).max() <= rtol * np.abs(xj).max()


def _mgcg_both(case, gamma):
    sj, st, grid, hj, ht = _build(case)
    rj, _ = jmg.mgcg_solve(sj.A, sj.b, grid, policy=JPolicy(tol=1e-10, norm="rel_l2"), hierarchy=hj,
                           gamma=gamma)
    rt, _ = tmg.mgcg_solve(st.A, st.b, grid, policy=ConvergencePolicy(tol=1e-10, norm="rel_l2"),
                           hierarchy=ht, gamma=gamma)
    assert bool(rj.converged) and rt.converged
    assert rt.iterations == int(rj.iterations)
    _close(rt.x.numpy(), rj.x, 1e-10)
    r = st.b - oracle.spmv(st.A, rt.x.numpy())
    assert np.linalg.norm(r) / np.linalg.norm(st.b) < 1e-9
    return ht


@pytest.mark.parametrize("case", sorted(SOLVES))
def test_mgcg_fp64_matches_jax(case):
    _mgcg_both(case, 1)
