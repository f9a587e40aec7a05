"""The nonsymmetric and indefinite Krylov family of the port against the JAX
package's, on the CPU in fp64.

BiCGStab (plain and traced), GMRES (with a restart smaller than the solve
needs, and traced), FGMRES with each inner solve, MINRES, IDR(s) (the JAX
package's shadow draw carried across by ``convert.idr_shadow_from_reference``,
plain and traced), the Chebyshev iteration, ``bicgstab_solve_multi``,
``refined_solve(inner="bicgstab")`` with and without a grid, each
preconditioner prefix on each base and the (n, k) BiCGStab routes through
``api.solve``: equal iteration counts and x within 1e-10 ||x||.  The port's
own shadow draw is held to convergence and the true residual.
``method="auto"`` makes the JAX package's choice on SPD, indefinite and
nonsymmetric systems, with and without a grid; every method still to port
raises ``NotImplementedError`` naming its ROADMAP item.  Inputs come from
the generators (bit-identical in ``test_torch_nonsym_generators.py``) and
numpy seeds."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.solvers import bicgstab as jbicg
from conjugategradient_tpu.solvers import cheby as jcheby
from conjugategradient_tpu.solvers import gmres as jgmres
from conjugategradient_tpu.solvers import idr as jidr
from conjugategradient_tpu.solvers import minres as jminres
from conjugategradient_tpu.solvers.multi import bicgstab_solve_multi as j_bicg_multi
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu.solvers.refine import refined_solve as j_refined
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import idr_shadow_from_reference
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.solvers import bicgstab as tbicg
from conjugategradient_tpu_torch.solvers import cheby as tcheby
from conjugategradient_tpu_torch.solvers import gmres as tgmres
from conjugategradient_tpu_torch.solvers import idr as tidr
from conjugategradient_tpu_torch.solvers import minres as tminres
from conjugategradient_tpu_torch.solvers.multi import bicgstab_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi

#: the same recurrence in fp64: x within this fraction of ||x||
X_REL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _lam1(grid):
    """The smallest eigenvalue of the Dirichlet Laplacian on ``grid``."""
    return sum(2.0 - 2.0 * np.cos(np.pi / (g + 1)) for g in grid)


#: name -> (generator call, grid); each made by both packages' generators
SYSTEMS = {
    "cd 15^2 eps 0.05 upwind": (lambda g: g.convection_diffusion_system((15, 15), eps=0.05),
                                (15, 15)),
    "cd 31^2 eps 0.05 upwind": (lambda g: g.convection_diffusion_system((31, 31), eps=0.05),
                                (31, 31)),
    "cd 15^2 eps 1.0 upwind": (lambda g: g.convection_diffusion_system((15, 15), eps=1.0),
                               (15, 15)),
    "cd 15^2 eps 1.0 central": (lambda g: g.convection_diffusion_system(
        (15, 15), eps=1.0, scheme="central"), (15, 15)),
    "cd 23^2 eps 1.0 upwind": (lambda g: g.convection_diffusion_system((23, 23), eps=1.0),
                               (23, 23)),
    "cd 31^2 eps 1.0 central": (lambda g: g.convection_diffusion_system(
        (31, 31), eps=1.0, scheme="central"), (31, 31)),
    "cd 47^2 eps 1.0 upwind": (lambda g: g.convection_diffusion_system((47, 47), eps=1.0),
                               (47, 47)),
    "helmholtz 24^2": (lambda g: g.helmholtz_system((24, 24), 1.5 * _lam1((24, 24))), (24, 24)),
    "band 512 x 8": (lambda g: g.nonsymmetric_banded_system(512, 8), None),
    "poisson 15x17": (lambda g: g.poisson_system((15, 17)), (15, 17)),
    "poisson 47^2": (lambda g: g.poisson_system((47, 47)), (47, 47)),
}


def _systems(name):
    make, grid = SYSTEMS[name]
    return make(tgen), make(jgen), grid


def _jax_shadow(n, s=4, seed=0):
    """The JAX package's IDR(s) draw, before its columns are normalised."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, s), jnp.float64))


def _agree(rt, rj, iterations=None):
    """Equal counts and flags, x within X_REL ||x||."""
    assert int(rt.iterations) == int(rj.iterations) == (iterations or int(rj.iterations))
    assert bool(rt.converged) == bool(rj.converged)
    xt, xj = np.asarray(rt.x), np.asarray(rj.x)
    assert np.linalg.norm(xt - xj) <= X_REL * np.linalg.norm(xj)


def _pols(**kw):
    return ConvergencePolicy(**kw), JPolicy(**kw)


@pytest.mark.parametrize("name", ["cd 15^2 eps 1.0 upwind", "cd 31^2 eps 1.0 central",
                                  "band 512 x 8"])
def test_bicgstab_matches_jax(name):
    st, sj, _ = _systems(name)
    pt, pj = _pols(tol=1e-10, norm="rel_l2", max_iteration=2000)
    rt = tbicg.bicgstab_solve(st.A.device_put(device="cpu"), torch.from_numpy(st.b), policy=pt)
    rj = jbicg.bicgstab_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj)
    assert rt.converged
    _agree(rt, rj)


def test_bicgstab_traced_matches_jax_and_the_loop():
    st, sj, _ = _systems("cd 15^2 eps 1.0 central")
    pt, pj = _pols(tol=1e-8, norm="rel_l2")
    x0 = np.random.default_rng(1).standard_normal(st.n)
    rt, ht = tbicg.bicgstab_solve_traced(st.A, torch.from_numpy(st.b), torch.from_numpy(x0),
                                         policy=pt, num_steps=90)
    rj, hj = jbicg.bicgstab_solve_traced(sj.A.device_put(), jnp.asarray(sj.b), jnp.asarray(x0),
                                         policy=pj, num_steps=90)
    _agree(rt, rj)
    loop = tbicg.bicgstab_solve(st.A, torch.from_numpy(st.b), torch.from_numpy(x0), policy=pt)
    assert rt.converged and loop.iterations == rt.iterations < 90
    np.testing.assert_array_equal(loop.x.numpy(), rt.x.numpy())
    its = rt.iterations
    np.testing.assert_allclose(ht.numpy()[:its], np.asarray(hj)[:its], rtol=0,
                               atol=1e-10 * float(hj[0]))
    assert np.all(ht.numpy()[its:] == ht.numpy()[its - 1])  # frozen after convergence


@pytest.mark.parametrize("name,restart", [("cd 23^2 eps 1.0 upwind", 8),
                                          ("cd 15^2 eps 0.05 upwind", 32)])
def test_gmres_matches_jax(name, restart):
    st, sj, _ = _systems(name)
    pt, pj = _pols(tol=1e-10, norm="rel_l2", max_iteration=3000)
    rt = tgmres.gmres_solve(st.A, torch.from_numpy(st.b), policy=pt, restart=restart)
    rj = jgmres.gmres_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj, restart=restart)
    assert rt.converged and rt.iterations > restart  # restarted at least once
    _agree(rt, rj)
    # FGMRES with a linear M makes GMRES's iterates
    inv = torch.from_numpy(1.0 / st.A.data[st.A.offsets.index(0)])
    g = tgmres.gmres_solve(st.A, torch.from_numpy(st.b), policy=pt, restart=restart,
                           M=lambda r: inv * r)
    f = tgmres.fgmres_solve(st.A, torch.from_numpy(st.b), policy=pt, restart=restart,
                            M=lambda r: inv * r)
    assert g.iterations == f.iterations and g.converged
    np.testing.assert_allclose(f.x.numpy(), g.x.numpy(), rtol=0, atol=1e-10 * g.x.abs().max())


def test_gmres_traced_matches_jax():
    st, sj, _ = _systems("cd 23^2 eps 1.0 upwind")
    pt, pj = _pols(tol=1e-9, norm="rel_l2")
    rt, ht, it_t = tgmres.gmres_solve_traced(st.A, torch.from_numpy(st.b), policy=pt, restart=32,
                                             num_cycles=12)
    rj, hj, it_j = jgmres.gmres_solve_traced(sj.A.device_put(), jnp.asarray(sj.b), policy=pj,
                                             restart=32, num_cycles=12)
    _agree(rt, rj)
    assert rt.converged
    np.testing.assert_array_equal(it_t.numpy(), np.asarray(it_j))
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=1e-8, atol=1e-15)


@pytest.mark.parametrize("inner,name", [("bicgstab", "cd 23^2 eps 1.0 upwind"),
                                        ("cg", "cd 23^2 eps 1.0 upwind"),
                                        ("chebyshev", "poisson 15x17")])
def test_fgmres_inner_matches_jax(inner, name):
    st, sj, _ = _systems(name)
    opts = dict(method="fgmres", inner=inner, inner_iterations=4, restart=8, tol=1e-10,
                norm="rel_l2")
    rt = api.solve(st.A, st.b, device="cpu", **opts)
    rj = japi.solve(sj.A, sj.b, **opts)
    assert rt.converged
    _agree(rt, rj)


def test_minres_matches_jax_on_helmholtz():
    st, sj, _ = _systems("helmholtz 24^2")
    pt, pj = _pols(tol=1e-10, norm="rel_l2")
    rt = tminres.minres_solve(st.A, torch.from_numpy(st.b), policy=pt)
    rj = jminres.minres_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj)
    assert rt.converged
    _agree(rt, rj)
    r = st.b - oracle.spmv(st.A, rt.x.numpy())
    assert np.linalg.norm(r) <= 1e-9 * np.linalg.norm(st.b)
    # CG on the indefinite operator does not converge in the same budget
    cg = api.solve(st.A, st.b, method="cg", tol=1e-10, norm="rel_l2", device="cpu",
                   max_iteration=rt.iterations)
    assert not cg.converged


@pytest.mark.parametrize("s,name", [(4, "cd 15^2 eps 1.0 central"), (2, "cd 15^2 eps 1.0 upwind")])
def test_idr_with_the_jax_shadow_matches_jax(s, name):
    st, sj, _ = _systems(name)
    pt, pj = _pols(tol=1e-10, norm="rel_l2", max_iteration=4000)
    shadow = idr_shadow_from_reference(_jax_shadow(st.n, s), device="cpu")
    rt = tidr.idr_solve(st.A, torch.from_numpy(st.b), policy=pt, s=s, shadow=shadow)
    rj = jidr.idr_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj, s=s)
    assert rt.converged and rt.iterations % (s + 1) == 0
    _agree(rt, rj)
    tt, ht = tidr.idr_solve_traced(st.A, torch.from_numpy(st.b), policy=pt, s=s, shadow=shadow,
                                   num_cycles=rt.iterations // (s + 1) + 3)
    tj, hj = jidr.idr_solve_traced(sj.A.device_put(), jnp.asarray(sj.b), policy=pj, s=s,
                                   num_cycles=rt.iterations // (s + 1) + 3)
    _agree(tt, tj, rt.iterations)
    # rounding grows mid-solve and shrinks again: the history within 1e-9
    # of its start, the final x (above) within 1e-10
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), rtol=0, atol=1e-9 * float(hj[0]))


@pytest.mark.parametrize("method", ["bicgstab", "idr"])
def test_transport_dominated_solves_stay_within_the_jax_packages_own_spread(method):
    """At eps 0.05 with no preconditioner, BiCGStab's and IDR's recurrences
    amplify rounding (on 15^2 the JAX package's own BiCGStab count moves
    115 -> 116 and its x by 9e-10 relative when b moves by one ulp), so the
    port is held to that spread: x within 10x the JAX package's distance to
    itself under a one-ulp change of b, the counts within twice its count
    change or 5, both converged to the true residual."""
    st, sj, _ = _systems("cd 15^2 eps 0.05 upwind")
    opts = dict(method=method, tol=1e-10, norm="rel_l2", max_iteration=3000)
    extra = dict(shadow=_jax_shadow(st.n)) if method == "idr" else {}
    rt = api.solve(st.A, st.b, device="cpu", **opts, **extra)
    rj = japi.solve(sj.A, sj.b, **opts)
    rj1 = japi.solve(sj.A, np.nextafter(sj.b, np.inf), **opts)
    assert rt.converged and bool(rj.converged) and bool(rj1.converged)
    xj, nx = np.asarray(rj.x), np.linalg.norm(np.asarray(rj.x))
    spread = np.linalg.norm(np.asarray(rj1.x) - xj) / nx
    assert np.linalg.norm(rt.x.numpy() - xj) / nx <= 10 * spread
    count_spread = abs(int(rj1.iterations) - int(rj.iterations))
    assert abs(rt.iterations - int(rj.iterations)) <= max(2 * count_spread, 5)
    true = np.linalg.norm(st.b - oracle.spmv(st.A, rt.x.numpy())) / np.linalg.norm(st.b)
    assert true <= 1e-9


def test_idr_accepts_convergence_only_on_a_replaced_residual():
    """The port's repair of IDR's exit: fp32, 63^2 convection at eps 0.5,
    no scheduled replacement, tol 1e-6.  The JAX package's loop stops on a
    recurrence residual of 3.7e-7 whose true residual is 4.7e-6; the
    port's replaces the residual where the recurrence claims convergence
    and ends on a true residual under the tolerance (CPU runs, fp32)."""
    g, tol = (63, 63), 1e-6
    st = tgen.convection_diffusion_system(g, eps=0.5, dtype=np.float32)
    sj = jgen.convection_diffusion_system(g, eps=0.5, dtype=np.float32)
    nb = np.linalg.norm(st.b)
    true = lambda x: np.linalg.norm(st.b - oracle.spmv(st.A, np.asarray(x, np.float64))) / nb
    pt, pj = _pols(tol=tol, norm="rel_l2", max_iteration=4000)
    rj = jidr.idr_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj, replace_every=0)
    assert bool(rj.converged) and float(rj.residual) < tol < true(rj.x)
    draw = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (st.n, 4), jnp.float32))
    rt = tidr.idr_solve(st.A, torch.from_numpy(st.b), policy=pt, replace_every=0, shadow=draw)
    assert rt.converged and rt.replacements >= 1
    assert true(rt.x.numpy()) < tol
    assert abs(true(rt.x.numpy()) - float(rt.residual)) <= 0.05 * float(rt.residual)


def test_idr_own_shadow_converges_to_the_true_residual():
    st, _, _ = _systems("cd 15^2 eps 0.05 upwind")
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=4000)
    r = tidr.idr_solve(st.A, torch.from_numpy(st.b), policy=pol, seed=3)
    assert r.converged
    true = np.linalg.norm(st.b - oracle.spmv(st.A, r.x.numpy())) / np.linalg.norm(st.b)
    assert true <= 1e-9
    # the draw is the seed's: the same seed, the same iterates
    again = tidr.idr_solve(st.A, torch.from_numpy(st.b), policy=pol, seed=3)
    assert again.iterations == r.iterations and torch.equal(again.x, r.x)
    with pytest.raises(ValueError, match=r"\(n, s\)"):
        tidr.idr_solve(st.A, torch.from_numpy(st.b), policy=pol,
                       shadow=torch.zeros(st.n, 3))
    with pytest.raises(ValueError, match=r"\(n, s\)"):
        idr_shadow_from_reference(np.zeros(5))


def test_chebyshev_matches_jax():
    st, sj, _ = _systems("poisson 15x17")
    bt, bj = tcheby.estimate_bounds(st.A), jcheby.estimate_bounds(sj.A)
    assert bt == bj
    pt, pj = _pols(tol=1e-10, norm="rel_l2")
    rt = tcheby.chebyshev_solve(st.A, torch.from_numpy(st.b), policy=pt, check_every=7)
    rj = jcheby.chebyshev_solve(sj.A.device_put(), jnp.asarray(sj.b), policy=pj, check_every=7)
    assert rt.converged and rt.iterations % 7 == 0
    _agree(rt, rj)
    capped = tcheby.chebyshev_solve(st.A, torch.from_numpy(st.b), bounds=bt, check_every=7,
                                    policy=ConvergencePolicy(tol=1e-10, max_iteration=10))
    assert capped.iterations == 10 and not capped.converged


def test_bicgstab_solve_multi_matches_jax_k3():
    st, sj, _ = _systems("cd 15^2 eps 1.0 upwind")
    B = np.column_stack([st.b] + [np.random.default_rng(j).standard_normal(st.n) for j in (1, 2)])
    B[:, 2] *= 1e-3  # an absolute tolerance met at another count
    pt, pj = _pols(tol=1e-9, norm="l2", max_iteration=2000)
    rt = bicgstab_solve_multi(st.A, torch.from_numpy(B), policy=pt)
    rj = j_bicg_multi(sj.A.device_put(), jnp.asarray(B), policy=pj)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    assert np.linalg.norm(xt - xj) <= X_REL * np.linalg.norm(xj)
    # column 0 takes the single-RHS count
    single = tbicg.bicgstab_solve(st.A, torch.from_numpy(st.b), policy=pt)
    assert int(rt.iterations[0]) == single.iterations


@pytest.mark.parametrize("grid", [None, (31, 31)])
def test_refined_bicgstab_matches_jax(grid):
    st, sj, _ = _systems("cd 31^2 eps 1.0 central")
    kw = dict(tol=1e-9, grid=grid, inner="bicgstab", device_dtype=np.float64)
    rt = refined_solve(st.A, st.b, device="cpu", **kw)
    rj = j_refined(sj.A, sj.b, **kw)
    assert rt.converged and rj.converged
    assert (rt.outer_iterations, rt.inner_iterations) == (rj.outer_iterations, rj.inner_iterations)
    assert np.linalg.norm(rt.x - rj.x) <= X_REL * np.linalg.norm(rj.x)
    # fp32 inner solves reach the fp64 tolerance too, host and device residual
    for dev_res in (False, True):
        r32 = refined_solve(st.A, st.b, tol=1e-9, grid=grid, inner="bicgstab", device="cpu",
                            device_residual=dev_res)
        assert r32.converged
        assert np.linalg.norm(st.b - oracle.spmv(st.A, r32.x)) < 1e-9
    B = np.column_stack([st.b, np.random.default_rng(5).standard_normal(st.n)])
    m = refined_solve_multi(st.A, B, tol=1e-9, grid=grid, inner="bicgstab", device="cpu")
    assert m.converged.all()
    for j in range(2):
        assert np.linalg.norm(B[:, j] - oracle.spmv(st.A, m.x[:, j])) < 1e-9
    with pytest.raises(ValueError, match="deflation requires inner='cg'"):
        refined_solve(st.A, st.b, inner="bicgstab", deflation=object(), device="cpu")
    # deflation= is ported (tests/test_torch_deflation.py); it takes a
    # Deflation and nothing else
    with pytest.raises(TypeError, match="must be a solvers.deflation.Deflation"):
        refined_solve(st.A, st.b, deflation=object(), device="cpu")


def _prefix_system(prefix, base):
    """The system a prefixed route runs on: 47^2 for ``mg_`` (past the
    1025 unknowns of the coarsest grid, so the cycle has a level), 31^2 at
    eps 0.05 else; Poisson for ``minres``; unpreconditioned, 23^2 at eps 1
    (see the spread test above for eps 0.05)."""
    if prefix is None:
        return "cd 23^2 eps 1.0 upwind"
    if base == "minres":
        return "poisson 47^2" if prefix == "mg" else "poisson 15x17"
    return "cd 47^2 eps 1.0 upwind" if prefix == "mg" else "cd 31^2 eps 0.05 upwind"


@pytest.mark.parametrize("base", ["bicgstab", "fgmres", "gmres", "idr", "minres"])
@pytest.mark.parametrize("prefix", ["jacobi", "bjacobi", "mg", "amg"])
def test_prefix_on_base_matches_jax(prefix, base):
    st, sj, grid = _systems(_prefix_system(prefix, base))
    method = f"{prefix}_{base}"
    opts = dict(method=method, tol=1e-10, norm="rel_l2", max_iteration=3000)
    extra = dict(grid=grid) if prefix == "mg" else {}
    port_extra = dict(shadow=_jax_shadow(st.n)) if base == "idr" else {}
    rt = api.solve(st.A, st.b, device="cpu", **opts, **extra, **port_extra)
    rj = japi.solve(sj.A, sj.b, **opts, **extra)
    assert rt.converged, method
    _agree(rt, rj)


@pytest.mark.parametrize("method", ["bicgstab", "jacobi_bicgstab", "bjacobi_bicgstab",
                                    "mg_bicgstab", "amg_bicgstab"])
def test_multi_rhs_bicgstab_routes_match_jax(method):
    st, sj, grid = _systems(_prefix_system(method.split("_")[0] if "_" in method else None,
                                           "bicgstab"))
    B = np.column_stack([st.b, np.random.default_rng(8).standard_normal(st.n)])
    opts = dict(method=method, tol=1e-10, norm="rel_l2")
    extra = dict(grid=grid) if method.startswith("mg_") else {}
    rt = api.solve(st.A, B, device="cpu", **opts, **extra)
    rj = japi.solve(sj.A, B, **opts, **extra)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert bool(rt.converged.all())
    xt, xj = rt.x.numpy(), np.asarray(rj.x)
    assert np.linalg.norm(xt - xj) <= X_REL * np.linalg.norm(xj)


@pytest.mark.parametrize("name,grid_too", [("poisson 15x17", True), ("helmholtz 24^2", True),
                                           ("cd 15^2 eps 0.05 upwind", True),
                                           ("band 512 x 8", False)])
def test_auto_chooses_as_jax_does(name, grid_too):
    st, sj, grid = _systems(name)
    for g in ((None, grid) if grid_too else (None,)):
        assert api._auto_method(st.A, g) == japi._auto_method(sj.A, g)
    # a card-resident container is probed on the host
    assert api._auto_method(st.A.device_put(device="cpu"), None) == japi._auto_method(sj.A, None)


def test_auto_probe_finds_the_negative_eigenvalue_the_jax_probe_misses():
    """The port's repair of the JAX probe: on 159^2 Helmholtz at 1.5
    lambda_1 (one eigenvalue at -0.5 lambda_1 = -2.9e-4 under a top of 8)
    the JAX package's 120 Lanczos steps bound the spectrum below by +5.4e-4
    and pick CG; the port's second, plain Lanczos of 4 sqrt(n) steps finds
    the negative Ritz value and picks MINRES.  At 0.5 lambda_1 (SPD) both
    pick CG."""
    from conjugategradient_tpu_torch.ops.spmv import as_operator
    from conjugategradient_tpu_torch.solvers.eigen import lanczos_ritz_bounds

    g = (159, 159)
    indefinite = 1.5 * _lam1(g)
    At, Aj = tgen.helmholtz_matrix(g, indefinite), jgen.helmholtz_matrix(g, indefinite)
    assert japi._auto_method(Aj, None) == "cg"
    assert api._auto_method(At, None, "cpu") == "minres"
    lo, hi = lanczos_ritz_bounds(as_operator(At.device_put(device="cpu")), At.n, 4 * 159,
                                 device="cpu")
    assert abs(lo - (_lam1(g) - indefinite)) <= 1e-6 and 7.9 < hi < 8.0
    assert api._auto_method(tgen.helmholtz_matrix(g, 0.5 * _lam1(g)), None, "cpu") == "cg"


@pytest.mark.parametrize("name,want", [("helmholtz 24^2", "minres"),
                                       ("cd 15^2 eps 0.05 upwind", "idr")])
def test_auto_solve_matches_jax(name, want):
    st, sj, _ = _systems(name)
    assert api._auto_method(st.A, None) == want
    opts = dict(method="auto", tol=1e-10, norm="rel_l2", max_iteration=4000)
    extra = dict(shadow=_jax_shadow(st.n)) if want == "idr" else {}
    rt = api.solve(st.A, st.b, device="cpu", **opts, **extra)
    rj = japi.solve(sj.A, sj.b, **opts)
    assert rt.converged
    _agree(rt, rj)
    if want == "idr":  # an (n, k) block takes block BiCGStab
        B = np.column_stack([st.b, st.b[::-1].copy()])
        rb = api.solve(st.A, B, device="cpu", **opts)
        ref = bicgstab_solve_multi(st.A, torch.from_numpy(B),
                                   policy=ConvergencePolicy(tol=1e-10, norm="rel_l2",
                                                            max_iteration=4000))
        np.testing.assert_array_equal(rb.iterations.numpy(), ref.iterations.numpy())
        with pytest.warns(RuntimeWarning, match="auto-dispatched method='idr' stalled"):
            api.solve(st.A, st.b, device="cpu", method="auto", tol=1e-10, max_iteration=5)


#: route -> (method keywords, the products its recurrence implies)
PRODUCTS = {
    "bicgstab": (dict(method="bicgstab"), lambda r: 2 * r.iterations + 1),
    "gmres restart 4": (dict(method="gmres", restart=4), lambda r: 1 + r.iterations + 2 * r.cycles),
    "fgmres inner bicgstab": (dict(method="fgmres", inner="bicgstab", inner_iterations=3),
                              lambda r: 1 + 2 * r.cycles + r.iterations * (2 + 2 * 3)),
    "minres": (dict(method="minres"), lambda r: r.iterations + 2),
    "idr": (dict(method="idr"), lambda r: 1 + r.iterations + r.replacements),
    "chebyshev": (dict(method="chebyshev", bounds=(0.5, 40.0)), lambda r: r.iterations + 1),
    "refined inner bicgstab": (dict(method="refined", inner="bicgstab"),
                               lambda r: 2 * r.inner_iterations + r.outer_iterations),
}


@pytest.mark.parametrize("route", sorted(PRODUCTS))
def test_products_per_route_match_the_recurrence(route, monkeypatch):
    """The accounting ``chip_smoke.py`` and the card tests hold kernel #4's
    launches to, on the CPU: the twin's calls counted per route."""
    from conjugategradient_tpu_torch.ops import cuda_dia

    calls = []
    twin = cuda_dia.spmv_dia_ref
    monkeypatch.setattr(cuda_dia, "spmv_dia_ref", lambda A, x: calls.append(1) or twin(A, x))
    s = tgen.nonsymmetric_banded_system(512, 8)
    if route == "minres":  # symmetric
        s = tgen.banded_sin_system(512, 8, x0_kind="zeros")
    kw, want = PRODUCTS[route]
    r = api.solve(s.A, s.b, device="cpu", tol=1e-9, norm="rel_l2", **kw)
    assert r.converged and len(calls) == want(r)


#: the methods the family's slice left to later slices, each ported since:
#: a single right-hand side solves, as in the JAX facade, and a block
#: raises the JAX facade's ``ValueError``
UNPORTED = ("lsmr", "cgnr", "cacg", "jacobi_cacg", "deflated_cg", "native")


@pytest.mark.parametrize("method", sorted(UNPORTED))
def test_methods_still_to_port_raise(method):
    s = tgen.tridiagonal_system(16)
    B = np.stack([s.b, s.b], 1)
    # past n iterations (CGNR and LSMR square kappa); a small probe for
    # deflated_cg (k = 4 of m = 8 Lanczos steps on 16 unknowns), each
    # package from its own start vector, so x is held to the direct solve
    # here and to the JAX package in the slice's own test files
    kw = dict(tol=1e-10, norm="rel_l2", max_iteration=2000)
    if method == "deflated_cg":
        kw.update(k=4, m=8)
    r = api.solve(s.A, s.b, method=method, device="cpu", **kw)
    jr = japi.solve(jgen.tridiagonal_system(16).A, s.b, method=method, **kw)
    assert r.converged and bool(jr.converged)
    x_true = oracle.direct_solve(s.A, s.b)
    assert np.abs(np.asarray(r.x) - x_true).max() <= 1e-7 * np.abs(x_true).max()
    with pytest.raises(ValueError, match="does not support"):
        api.solve(s.A, B, method=method, device="cpu")


def test_auto_on_a_rectangular_matrix_and_single_rhs_only_methods():
    from conjugategradient_tpu_torch.core.formats import DenseMatrix

    # a rectangular A routes to least squares, as in the JAX facade: on
    # this rank-1 matrix LSMR stops at the minimum-norm solution
    from conjugategradient_tpu.core.formats import DenseMatrix as JDense

    r = api.solve(DenseMatrix(np.ones((4, 3))), np.ones(4), method="auto", device="cpu")
    jr = japi.solve(JDense(np.ones((4, 3))), np.ones(4), method="auto")
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    np.testing.assert_allclose(r.x.numpy(), np.asarray(jr.x), rtol=1e-12)
    np.testing.assert_allclose(r.x.numpy(), np.full(3, 1.0 / 3.0), rtol=1e-12)
    s = tgen.tridiagonal_system(16)
    B = np.stack([s.b, s.b], 1)
    for method in ("gmres", "fgmres", "minres", "idr", "chebyshev", "mg_gmres", "amg_idr"):
        with pytest.raises(ValueError, match="does not support"):
            api.solve(s.A, B, method=method, device="cpu")
        with pytest.raises(ValueError, match="does not support"):
            japi.solve(jgen.tridiagonal_system(16).A, B, method=method)
    with pytest.raises(ValueError, match="no preconditioner prefix"):
        api.solve(s.A, s.b, method="mg_chebyshev", device="cpu")
    with pytest.raises(ValueError, match="requires grid="):
        api.solve(s.A, s.b, method="mg_bicgstab", device="cpu")
