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
- ``gspmd_mg_nonsym_solve`` on the even 32^2 convection grid (a 64-row
  coarsest level, so the V-cycle has levels) is sharded: the sharded loop
  of ``parallel.shard_nonsym`` with the sharded V-cycle.  Under
  BiCGStab, GMRES(20), FGMRES(20) and IDR(4) (the JAX draw carried
  across) it takes the JAX GSPMD program's count exactly and its x within
  X_REL (the JAX program runs the single-device four-dot BiCGStab, the
  port the two-collective one: the same iterates in exact arithmetic).
  On the odd 31^2 grid it is the single-device ``mg_bicgstab`` (the
  port's ``bicgstab_solve`` on the fine stencil with
  ``as_preconditioner``) bit for bit;
- ``api.solve(..., mesh=)`` routes ``mgcg``, ``refined``, (n, k)
  ``cg``/``bicgstab``/``mgcg``, the nonsymmetric bases, ``mg_*`` and
  ``amg_*`` as the JAX facade does, with its counts; ``eigs(mesh=)`` and
  2-D ``axes`` run (``tests/test_torch_mesh_eigs.py`` and
  ``tests/test_torch_gspmd_2d.py`` hold them to the JAX package): here
  each against the port's one-device or 1-D run.
"""

import functools

import jax
import jax.numpy as jnp
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
from conjugategradient_tpu_torch.parallel.gspmd import (
    gspmd_mg_nonsym_solve,
    gspmd_refined_solve,
    make_gspmd_mg_nonsym,
    make_gspmd_mgcg,
)
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, specs_for_grid
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy, mgcg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

X_REL = 1e-10
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)
EVEN, ODD = (64, 32), (63, 31)
#: the mg_* carrier's grids, eps, policy, coarsest size and restart
MG_EVEN, MG_ODD, MG_EPS = (32, 32), (31, 31), 0.05
MG_POL = dict(tol=1e-9, norm="rel_l2", max_iteration=500)
MG_KW = dict(max_coarse=64)
MG_RESTART = 20


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


def _mesh2(px, py):
    return Mesh([["cpu"] * py] * px, ("x", "y"))


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
    # axes=("x", "y") over a (2, 2) mesh: 2-D blocks, the same count and x
    solve2, (b2, x02) = make_gspmd_mgcg(s, EVEN, _mesh2(2, 2), ConvergencePolicy(**POL),
                                        axes=("x", "y"))
    assert solve2.n_sharded >= 1 and tuple(b2.shape) == (EVEN[0] // 2, EVEN[1] // 2)
    r2 = solve2(b2, x02)
    assert r2.iterations == r.iterations and _rel(r2.x.numpy(), jr.x) <= X_REL


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
    # POL's policy: the JAX facade's mgcg is then the program
    # test_gspmd_mgcg_even_grid_is_sharded_and_matches_jax compiled
    opts = dict(POL)
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


@pytest.fixture(scope="module")
def mg_case():
    """The 32^2 convection system and the JAX GSPMD mg_* solve on 4 devices
    of it by method (one JAX program each)."""
    cb = tgen.convection_diffusion_coarse_operator(eps=MG_EPS)
    s = tgen.convection_diffusion_system(MG_EVEN, eps=MG_EPS)
    jcb = jgen.convection_diffusion_coarse_operator(eps=MG_EPS)
    jax_mg = functools.cache(lambda method: jgspmd.gspmd_mg_nonsym_solve(
        _jA(s.A), s.b, MG_EVEN, mesh=j_mesh(4), policy=JPolicy(**MG_POL), method=method,
        coarse_operator=jcb, restart=MG_RESTART, **MG_KW))
    return cb, s, jax_mg


def test_gspmd_mg_bicgstab_even_grid_is_sharded(mg_case):
    cb, s, jax_mg = mg_case
    jr = jax_mg("bicgstab")
    solve, (b, x0) = make_gspmd_mg_nonsym(s.A, s.b, MG_EVEN, _mesh(4), ConvergencePolicy(**MG_POL),
                                          coarse_operator=cb, **MG_KW)
    assert solve.n_sharded >= 1 and isinstance(b, Shards)
    r = solve(b, x0)
    assert r.converged and bool(jr.converged)
    assert r.iterations == int(jr.iterations)
    assert _rel(r.x.numpy(), jr.x) <= X_REL


def test_gspmd_mg_bicgstab_odd_grid_is_the_single_device_solve():
    from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

    cb = tgen.convection_diffusion_coarse_operator(eps=MG_EPS)
    s = tgen.convection_diffusion_system(MG_ODD, eps=MG_EPS)
    pol = ConvergencePolicy(**MG_POL)
    h = build_hierarchy(s.A, MG_ODD, smoother="jacobi", coarse_operator=cb, device="cpu", **MG_KW)
    solve, _ = make_gspmd_mg_nonsym(s.A, s.b, MG_ODD, _mesh(4), pol, hierarchy=h)
    assert solve.n_sharded == 0
    r = gspmd_mg_nonsym_solve(s.A, s.b, MG_ODD, mesh=_mesh(4), policy=pol, hierarchy=h)
    one = bicgstab_solve(h.levels[0].A, torch.from_numpy(s.b).reshape(MG_ODD), policy=pol,
                         M=as_preconditioner(h))
    assert r.converged and r.iterations == one.iterations
    assert torch.equal(r.x, one.x.reshape(-1))


@pytest.mark.parametrize("method", ["gmres", "fgmres", "idr"])
def test_gspmd_mg_nonsym_variants_on_the_even_grid(mg_case, method):
    """The sharded V-cycle under GMRES(20), FGMRES(20) and IDR(4) on 4
    shards (IDR from the JAX package's draw): the JAX GSPMD count exactly,
    x within X_REL of its x and 1e-6 of the direct solve."""
    cb, s, jax_mg = mg_case
    jr = jax_mg(method)
    extra = {}
    if method == "idr":
        extra["shadow"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (s.n, 4),
                                                       jnp.float64))
    r = gspmd_mg_nonsym_solve(s.A, s.b, MG_EVEN, mesh=_mesh(4), policy=ConvergencePolicy(**MG_POL),
                              method=method, coarse_operator=cb, restart=MG_RESTART, **MG_KW,
                              **extra)
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x.numpy(), jr.x) <= X_REL
    assert _rel(r.x.numpy(), oracle.direct_solve(s.A, s.b)) <= 1e-6


def test_gspmd_mg_nonsym_refusals():
    s = tgen.convection_diffusion_system(MG_EVEN, eps=MG_EPS)
    with pytest.raises(ValueError, match="unknown method"):
        gspmd_mg_nonsym_solve(s.A, s.b, MG_EVEN, mesh=_mesh(4), method="minres")
    cb = tgen.convection_diffusion_coarse_operator(eps=MG_EPS)
    kw = dict(policy=ConvergencePolicy(**MG_POL), coarse_operator=cb, **MG_KW)
    r2 = gspmd_mg_nonsym_solve(s.A, s.b, MG_EVEN, mesh=_mesh2(2, 2), axes=("x", "y"), **kw)
    r1 = gspmd_mg_nonsym_solve(s.A, s.b, MG_EVEN, mesh=_mesh(4), **kw)
    assert r2.converged and r2.iterations == r1.iterations
    assert _rel(r2.x.numpy(), r1.x.numpy()) <= X_REL
    with pytest.raises(ValueError, match="own axes"):
        gspmd_mg_nonsym_solve(s.A, s.b, MG_EVEN, mesh=_mesh(4), axes=("x", "y"))


def test_facade_routes_still_to_port_raise(mg_case):
    """The sharded routes take the JAX facade's counts exactly (bicgstab
    and gmres on the band, mg_bicgstab, amg_cg); eigs(mesh=) and 2-D axes=
    still raise."""
    s = tgen.poisson_system(EVEN)
    m, jm = _mesh(4), j_mesh(4)
    band = tgen.banded_sin_system(512, 16)
    opts = dict(tol=1e-10, norm="rel_l2")
    for method in ("bicgstab", "gmres"):
        r = api.solve(band.A, band.b, method=method, mesh=m, dtype=np.float64, **opts)
        jr = japi.solve(_jA(band.A), band.b, method=method, mesh=jm, **opts)
        assert r.converged and r.iterations == int(jr.iterations), method
        assert _rel(r.x.numpy(), jr.x) <= X_REL, method
    cb, sc, jax_mg = mg_case
    jr = jax_mg("bicgstab")
    r = api.solve(sc.A, sc.b, method="mg_bicgstab", grid=MG_EVEN, mesh=m, coarse_operator=cb,
                  dtype=np.float64, **MG_POL, **MG_KW)
    assert r.converged and r.iterations == int(jr.iterations)
    assert _rel(r.x.numpy(), jr.x) <= X_REL
    from conjugategradient_tpu_torch.core.formats import dia_to_csr

    csr = dia_to_csr(band.A)
    r = api.solve(csr, band.b, method="amg_cg", mesh=m, dtype=np.float64, tol=1e-8, norm="rel_l2")
    jr = japi.solve(jformats.dia_to_csr(_jA(band.A)), band.b, method="amg_cg", mesh=jm, tol=1e-8,
                    norm="rel_l2")
    assert r.converged and r.iterations == int(jr.iterations)
    a = api.solve(s.A, s.b, method="mgcg", grid=EVEN, mesh=_mesh2(2, 2), axes=("x", "y"),
                  **opts)
    b = api.solve(s.A, s.b, method="mgcg", grid=EVEN, mesh=m, **opts)
    assert a.converged and a.iterations == b.iterations and _rel(a.x.numpy(), b.x.numpy()) <= X_REL
    e = api.eigs(s.A, k=2, which="SM", grid=EVEN, mesh=m, spd=True, dtype=torch.float64)
    one = api.eigs(s.A, k=2, which="SM", grid=EVEN, spd=True, dtype=torch.float64, device="cpu")
    assert e.converged and np.abs(e.values - one.values).max() <= 1e-8 * abs(one.values[0])
    with pytest.raises(ValueError, match="does not support"):
        api.solve(s.A, np.ones((s.n, 2)), method="jacobi_cg", mesh=m)
