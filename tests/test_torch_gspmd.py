"""The port's GSPMD carriers (``parallel.gspmd``) and the facade's new
``mesh=`` routes against the JAX package, on the CPU.

The JAX side partitions with XLA's SPMD partitioner on the 8-device CPU
mesh of ``tests/conftest.py``; the port carries the same semantics with
explicit collectives on ``make_mesh(k, devices=["cpu"] * k)``.  Same
arrays from the port's numpy generators, fp64.

- ``specs_for_grid`` keeps the JAX package's divisibility rule (its split
  where the JAX one returns PartitionSpecs), and ``shard_system`` places
  row blocks where the JAX package shards and one device's copy where it
  replicates;
- ``gspmd_mgcg_solve`` takes the JAX package's count on an even grid
  (sharded V-cycle, x within X_REL) and on an odd one, where it is the
  port's single-device ``mgcg_solve`` bit for bit;
- ``gspmd_refined_solve`` takes the JAX package's outer count within one
  pass and reaches ``||b - A x||_2 < tol``;
- ``api.solve(..., mesh=)`` routes ``mgcg``, ``refined`` and (n, k)
  ``cg``/``bicgstab``/``mgcg`` as the JAX facade does, with its counts;
  ``amg_*``, the nonsymmetric bases, ``eigs(mesh=)`` and 2-D ``axes``
  still raise ``NotImplementedError`` naming ROADMAP's parallel item.
"""

import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import gspmd as jgspmd
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel.mesh import specs_for_grid as j_specs
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.parallel import gspmd_mgcg_solve, make_mesh, shard_system
from conjugategradient_tpu_torch.parallel.gspmd import gspmd_refined_solve, make_gspmd_mgcg
from conjugategradient_tpu_torch.parallel.mesh import Shards, specs_for_grid
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy, mgcg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

X_REL = 1e-10
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)
EVEN, ODD = (64, 32), (63, 31)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(k):
    return make_mesh(k, devices=["cpu"] * k)


def _jA(A):
    return jformats.DiaMatrix(A.data, A.offsets, A.shape)


def _jsys(s):
    return jgen.LinearSystem(A=_jA(s.A), b=s.b, x0=s.x0)


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


@pytest.mark.parametrize("grid", [EVEN, ODD, (8, 12, 6), (16,)])
def test_specs_for_grid_keeps_the_jax_rule(grid):
    split = specs_for_grid(grid, _mesh(4), ("x",))
    dspec, vspec = j_specs(grid, j_mesh(4), ("x",))
    assert vspec == (P(*split.names) if split.sharded else P())
    assert dspec == (P(None, *split.names) if split.sharded else P())
    assert split.local == tuple(g // 4 if name else g for g, name in zip(grid, split.names))


def test_shard_system_places_rows_or_one_copy():
    m = _mesh(4)
    A, b, x0 = shard_system(tgen.poisson_system((16, 16)), m)
    assert isinstance(A.data, Shards) and isinstance(b, Shards) and isinstance(x0, Shards)
    assert tuple(A.data.shape) == (5, 64) and tuple(b.shape) == (64,)
    A, b, _ = shard_system(tgen.poisson_system((15, 15)), m)
    assert torch.is_tensor(A.data) and torch.is_tensor(b) and b.device == m.devices[0]


def test_gspmd_mgcg_even_grid_is_sharded_and_matches_jax():
    s = tgen.poisson_system(EVEN)
    solve, (b, x0) = make_gspmd_mgcg(s, EVEN, _mesh(4), ConvergencePolicy(**POL))
    assert solve.n_sharded >= 1 and isinstance(b, Shards)
    r = solve(b, x0)
    jr = jgspmd.gspmd_mgcg_solve(_jsys(s), EVEN, mesh=j_mesh(4), policy=JPolicy(**POL))
    assert r.converged and bool(jr.converged)
    assert r.iterations == int(jr.iterations) and _rel(r.x.numpy(), jr.x) <= X_REL
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: parallel"):
        make_gspmd_mgcg(s, EVEN, _mesh(4), axes=("x", "y"))


def test_gspmd_mgcg_odd_grid_is_the_single_device_solve():
    s = tgen.poisson_system(ODD)
    pol = ConvergencePolicy(**POL)
    h = build_hierarchy(s.A, ODD, device="cpu")
    solve, _ = make_gspmd_mgcg(s, ODD, _mesh(4), pol, hierarchy=h)
    assert solve.n_sharded == 0
    r = gspmd_mgcg_solve(s, ODD, mesh=_mesh(4), policy=pol, hierarchy=h)
    ref, _ = mgcg_solve(s.A, s.b, ODD, policy=pol, hierarchy=h)
    assert r.iterations == ref.iterations and torch.equal(r.x, ref.x)
    jr = jgspmd.gspmd_mgcg_solve(_jsys(s), ODD, mesh=j_mesh(4), policy=JPolicy(**POL))
    assert r.iterations == int(jr.iterations)


@pytest.mark.parametrize("grid", [EVEN, ODD])
def test_gspmd_refined_reaches_the_fp64_tolerance(grid):
    """1e3 times the generator's b (the absolute 1e-8 is then a real
    target): the outer count within one of the JAX package's double-float
    refinement on the even grid, of the port's single-device device-residual
    refinement on both."""
    from conjugategradient_tpu_torch.solvers.refine import refined_solve

    s = tgen.poisson_system(grid)
    b = s.b * 1e3
    r = gspmd_refined_solve(s.A, b, grid, mesh=_mesh(4), tol=1e-8)
    assert r.converged and np.linalg.norm(b - oracle.spmv(s.A, r.x)) < 1e-8
    one = refined_solve(s.A, b, grid=grid, device="cpu", device_residual=True, tol=1e-8)
    assert abs(r.outer_iterations - one.outer_iterations) <= 1
    if grid == EVEN:
        jr = jgspmd.gspmd_refined_solve(_jA(s.A), b, grid, mesh=j_mesh(4), tol=1e-8)
        assert bool(jr.converged) and abs(r.outer_iterations - jr.outer_iterations) <= 1


def test_facade_mesh_routes_match_the_jax_facade():
    s = tgen.poisson_system(EVEN)
    m, jm = _mesh(4), j_mesh(4)
    opts = dict(tol=1e-10, norm="rel_l2")
    r = api.solve(s.A, s.b, method="mgcg", grid=EVEN, mesh=m, dtype=np.float64, **opts)
    jr = japi.solve(_jA(s.A), s.b, method="mgcg", grid=EVEN, mesh=jm, **opts)
    assert r.iterations == int(jr.iterations) and _rel(r.x.numpy(), jr.x) <= X_REL
    b = s.b * 1e3
    rr = api.solve(s.A, b, method="refined", grid=EVEN, mesh=m)
    assert rr.converged and np.linalg.norm(b - oracle.spmv(s.A, rr.x)) < 1e-8
    with pytest.raises(TypeError, match="requires grid="):
        api.solve(s.A, b, method="refined", mesh=m)
    # the flat block solvers on the band (Poisson's BiCGStab counts move by
    # one under a one-ulp change, tests/test_torch_api.py), mgcg on the grid
    band = tgen.banded_sin_system(512, 16)
    for method, A in (("cg", band.A), ("bicgstab", band.A), ("mgcg", s.A)):
        B = np.random.default_rng(2).standard_normal((A.n, 2))
        r = api.solve(A, B, method=method, grid=EVEN, mesh=m, dtype=np.float64, **opts)
        jr = japi.solve(_jA(A), B, method=method, grid=EVEN, mesh=jm, **opts)
        np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(jr.iterations))
        assert _rel(r.x.numpy(), jr.x) <= X_REL


def test_facade_routes_still_to_port_raise():
    s = tgen.poisson_system(EVEN)
    m = _mesh(4)
    for method in ("amg_cg", "bicgstab", "gmres", "mg_bicgstab"):
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1: parallel"):
            api.solve(s.A, s.b, method=method, grid=EVEN, mesh=m)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: parallel"):
        api.solve(s.A, s.b, method="mgcg", grid=EVEN, mesh=m, axes=("x", "y"))
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1: parallel"):
        api.eigs(s.A, k=2, mesh=m)
    with pytest.raises(ValueError, match="does not support"):
        api.solve(s.A, np.ones((s.n, 2)), method="jacobi_cg", mesh=m)
