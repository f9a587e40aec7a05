"""W-cycle MGCG, full multigrid and the facade's ``gamma`` and ``layout``
over the hybrid, semicoarsening and aggregation hierarchies, against the
JAX package on the CPU in fp64: equal iteration counts and solutions within
1e-10 relative (fmg within 1e-12).  The V-cycle MGCG of the same cases is in
``test_torch_mg_solves.py``; inputs are made from numpy seeds and handed to
both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.precond import multigrid as tmg
from test_torch_mg_solves import SOLVES, _build, _close, _mgcg_both, _systems

#: the W-cycle differs from the V-cycle below the top level only: cases
#: with two or more levels
W_CASES = ["poisson 32^3 (hyb, agg)", "tridiagonal 4096 (agg, hyb)", "anisotropic 128^2 (semi)",
           "const_detect off hyb 32^2"]


@pytest.mark.parametrize("case", W_CASES)
def test_w_cycle_mgcg_fp64_matches_jax(case):
    _mgcg_both(case, 2)


@pytest.mark.parametrize("case", ["poisson 64^2 (hyb)", "transfer_kind agg 33^2",
                                  "anisotropic 128^2 (semi)", "layout dia 64^2",
                                  "smoother rbgs 64^2"])
def test_fmg_matches_jax(case):
    sj, st, grid, hj, ht = _build(case)
    b = st.b if SOLVES[case][2].get("layout") == "dia" else st.b.reshape(grid)
    xj = np.asarray(jmg.fmg(hj, jnp.asarray(b)))
    xt = tmg.fmg(ht, torch.from_numpy(b)).numpy()
    assert xt.shape == xj.shape == b.shape
    _close(xt, xj, 1e-12)
    flat = tmg.fmg(ht, torch.from_numpy(st.b)).numpy()  # flat in, flat out
    assert flat.shape == (st.n,)
    _close(flat, xj.reshape(-1), 1e-12)


def test_facade_passes_gamma_and_layout():
    grid = (64, 64)
    sj, st = _systems("poisson", grid)
    kw = dict(method="mgcg", grid=grid, tol=1e-10, norm="rel_l2", gamma=2, layout="dia")
    rt = api.solve(st.A, st.b, device="cpu", **kw)
    rj = japi.solve(sj.A, sj.b, **kw)
    assert rt.converged and bool(rj.converged) and rt.iterations == int(rj.iterations)
    _close(rt.x.numpy(), rj.x, 1e-10)
