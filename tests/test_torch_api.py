"""Generators, workloads, multi-RHS CG and the ``api.solve`` facade of the
port against the JAX package's, on the CPU.

The host generators and the workload table are copies: they must be
bit-identical and field-for-field equal.  ``cg_solve_multi`` in fp64 runs
the same per-column recurrence as the JAX package's, so the per-column
iteration counts are equal, with or without the multi-RHS V-cycle.  The
facade's methods take the JAX facade's iteration counts (``sharded_cg``
and ``amg_cg`` with ``mesh=`` on 8-shard meshes on both sides, the
replicated ``mg_bicgstab`` on 2-shard ones); what the port does not have
raises its error, a route still to port ``NotImplementedError`` naming its
ROADMAP item.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.models import workloads as jwl
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.multi import cg_solve_multi as j_cg_multi
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.models import workloads as twl
from conjugategradient_tpu_torch.ops.spmv import spmv_dia
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
from conjugategradient_tpu_torch.solvers.multi import (
    as_multi_preconditioner,
    bicgstab_solve_multi,
    cg_solve_multi,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _same_system(a, b):
    assert a.A.offsets == b.A.offsets and a.A.shape == b.A.shape
    for u, v in ((a.A.data, b.A.data), (a.b, b.b), (a.x0, b.x0)):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and np.array_equal(u, v)


@pytest.mark.parametrize("b_kind", ["cos10", "one_plus", "asin"])
@pytest.mark.parametrize("x0_kind", ["i/100", "i/10", "zeros"])
def test_banded_sin_system_bit_identical(b_kind, x0_kind):
    for n, band, dt in ((1000, 16, np.float64), (333, 8, np.float32)):
        _same_system(tgen.banded_sin_system(n, band, b_kind, x0_kind, dtype=dt),
                     jgen.banded_sin_system(n, band, b_kind, x0_kind, dtype=dt))


def test_tridiagonal_system_bit_identical():
    for n in (1, 2, 1023):
        _same_system(tgen.tridiagonal_system(n), jgen.tridiagonal_system(n))
    offs_t, data_t = tgen.tridiagonal_rows(50, 10, 30, diag=3.0, off=-1.0)
    offs_j, data_j = jgen.tridiagonal_rows(50, 10, 30, diag=3.0, off=-1.0)
    assert offs_t == offs_j and np.array_equal(data_t, data_j)
    offs_t, data_t = tgen.banded_sin_rows(500, 12, 100, 200)
    offs_j, data_j = jgen.banded_sin_rows(500, 12, 100, 200)
    assert offs_t == offs_j and np.array_equal(data_t, data_j)
    with pytest.raises(ValueError, match="band"):
        tgen.banded_sin_matrix(10, 7)


def test_every_workload_field_equals_jax():
    assert list(twl.WORKLOADS) == list(jwl.WORKLOADS)
    assert twl.LADDER == jwl.LADDER
    for name, wt in twl.WORKLOADS.items():
        wj = jwl.WORKLOADS[name]
        for f in dataclasses.fields(wt):
            vt, vj = getattr(wt, f.name), getattr(wj, f.name)
            if f.name == "policy":
                vt, vj = dataclasses.asdict(vt), dataclasses.asdict(vj)
            assert vt == vj, (name, f.name)
        assert wt.size == wj.size
    for name in ("viennacl_small", "r_prototype", "ladder_dense_1k"):
        _same_system(twl.build(name), jwl.build(name))
    with pytest.raises(KeyError, match="unknown workload"):
        twl.get("nope")
    for name in ("cublas_flagship", "simple_cuda", "viennacl_large"):
        got = twl.get(name).build_rows(1000, 1037)
        want = jwl.WORKLOADS[name].build_rows(1000, 1037)
        assert got[0] == want[0]
        for a, b in zip(got[1:], want[1:]):
            assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("norm", ["l2", "rel_l2", "linf"])
def test_cg_solve_multi_per_column_iterations_equal_jax_fp64(norm):
    s = tgen.banded_sin_system(768, 12)
    B = np.random.default_rng(2).standard_normal((s.n, 4))
    B[:, 3] *= 1e-3  # columns reach an absolute tolerance at different counts
    pol = dict(tol=1e-8, norm=norm, max_iteration=2000)
    rt = cg_solve_multi(s.A.device_put(), torch.from_numpy(B), policy=ConvergencePolicy(**pol))
    rj = j_cg_multi(jgen.banded_sin_system(768, 12).A.device_put(), jnp.asarray(B),
                    policy=JPolicy(**pol))
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert bool(rt.converged.all()) and bool(np.asarray(rj.converged).all())
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-12)


def test_cg_solve_multi_preconditioner_and_callable_operator():
    s = tgen.tridiagonal_system(200)
    A = s.A.device_put()
    B = torch.from_numpy(np.random.default_rng(7).standard_normal((s.n, 3)))
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2")
    inv = 1.0 / A.data[1]
    plain = cg_solve_multi(A, B, policy=pol)
    jac = cg_solve_multi(A, B, policy=pol, M=lambda R: inv[:, None] * R)
    fn = cg_solve_multi(lambda P: torch.stack([spmv_dia(A, P[:, j]) for j in range(3)], 1), B,
                        policy=pol)
    # 200 rows are below max_coarse: the V-cycle is the dense inverse
    mg = cg_solve_multi(A, B, policy=pol,
                        M=as_multi_preconditioner(build_hierarchy(s.A, (s.n,), device="cpu")))
    assert int(mg.iterations.max()) <= 2
    for r in (plain, jac, fn, mg):
        assert bool(r.converged.all())
        np.testing.assert_allclose(r.x.numpy(), plain.x.numpy(), rtol=1e-7, atol=1e-9)
    # the nonsymmetric block solver on the same SPD system: the same x
    bi = bicgstab_solve_multi(A, B, policy=ConvergencePolicy(tol=1e-10, norm="rel_l2",
                                                             max_iteration=4000))
    assert bool(bi.converged.all())
    np.testing.assert_allclose(bi.x.numpy(), plain.x.numpy(), rtol=1e-7, atol=1e-9)


def test_facade_cg_matches_jax_fp64():
    st = tgen.banded_sin_system(500, 10)
    sj = jgen.banded_sin_system(500, 10)
    rt = api.solve(st.A, st.b, st.x0, method="cg", tol=1e-9, device="cpu")
    rj = japi.solve(sj.A, sj.b, sj.x0, method="cg", tol=1e-9)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9, atol=1e-12)


def test_facade_oracle_refined_and_mgcg():
    s = tgen.banded_sin_system(1024, 16)
    o = api.solve(s.A, s.b, s.x0, method="oracle", tol=1e-10)
    assert o.converged and o.iterations == oracle.cg(s.A, s.b, s.x0, tol=1e-10).iterations
    r = api.solve(s.A, s.b, s.x0, method="refined", tol=1e-10, device="cpu")
    assert r.converged and np.linalg.norm(s.b - oracle.spmv(s.A, r.x)) < 1e-10
    grid = (63, 63)
    p = tgen.poisson_system(grid)
    m = api.solve(p.A, p.b, method="mgcg", grid=grid, tol=1e-8, norm="rel_l2", device="cpu",
                  coarse_operator=tgen.poisson_coarse_operator())
    jA = jgen.poisson_system(grid).A
    hj = jmg.build_hierarchy(jA, grid, coarse_operator=jgen.poisson_coarse_operator())
    jm = japi.solve(jA, p.b, method="mgcg", grid=grid, tol=1e-8, norm="rel_l2", hierarchy=hj)
    assert m.converged and m.iterations == int(jm.iterations)


def test_facade_multi_rhs_routes():
    s = tgen.tridiagonal_system(255)
    B = np.random.default_rng(5).standard_normal((s.n, 2))
    c = api.solve(s.A, B, method="cg", tol=1e-10, norm="rel_l2", device="cpu")
    jc = japi.solve(jgen.tridiagonal_system(255).A, B, method="cg", tol=1e-10, norm="rel_l2")
    np.testing.assert_array_equal(c.iterations.numpy(), np.asarray(jc.iterations))
    r = api.solve(s.A, B, method="refined", tol=1e-9, device="cpu")
    assert r.converged.all() and hasattr(r, "stalled")
    for j in range(2):
        assert np.linalg.norm(B[:, j] - oracle.spmv(s.A, r.x[:, j])) < 1e-9
    m = api.solve(s.A, B, method="mgcg", grid=(255,), tol=1e-10, norm="rel_l2", device="cpu")
    jm = japi.solve(jgen.tridiagonal_system(255).A, B, method="mgcg", grid=(255,), tol=1e-10,
                    norm="rel_l2")
    assert bool(m.converged.all())
    np.testing.assert_array_equal(m.iterations.numpy(), np.asarray(jm.iterations))


#: each facade method's outcome on the port: ``None`` where it is ported
#: (it must then equal the JAX facade), else the error and its message
FACADE = {
    **dict.fromkeys(("native", "cheb_cg", "jacobi_cg", "amg_cg", "bicgstab", "gmres", "fgmres", "minres",
                     "idr", "chebyshev", "auto", "bjacobi_bicgstab", "mg_gmres", "lsmr", "cgnr",
                     "cacg", "deflated_cg"), None),
    "sharded_cg": None,
    "amg_cg mesh=": None,
    "jacobi_chebyshev": (ValueError, "no preconditioner prefix"),
}


#: ported methods with no (n, k) route: both facades raise ValueError
_SINGLE_ONLY = ("native", "cheb_cg", "gmres", "fgmres", "minres", "idr", "chebyshev", "mg_gmres", "lsmr",
                "cgnr", "cacg", "deflated_cg", "sharded_cg")


@pytest.mark.parametrize("method", sorted(FACADE))
def test_unported_facade_methods_raise(method):
    """Each method the port does not have raises, naming its ROADMAP item;
    each method it has takes the JAX facade's iteration counts in fp64
    (single-RHS and, where the JAX facade has one, (n, k)), and a method
    with no (n, k) route raises the JAX facade's ``ValueError`` on a
    block.  ``idr`` takes the JAX package's shadow draw, ``deflated_cg`` the
    JAX deflation the JAX facade builds (``convert.deflation_from_reference``)."""
    name, _, extra = method.partition(" ")
    kw = dict(mesh=object()) if extra == "mesh=" else {}
    if FACADE[method] is not None:
        err, msg = FACADE[method]
        s = tgen.tridiagonal_system(16)
        with pytest.raises(err, match=msg):
            api.solve(s.A, s.b, method=name, device="cpu", **kw)
        B = np.stack([s.b, s.b], 1)
        if extra == "mesh=":
            # (n, k) with mesh=: a method with no sharded block carrier takes
            # the JAX facade's ValueError, as the JAX facade raises it
            err, msg = ValueError, "does not support"
            with pytest.raises(err, match=msg):
                japi.solve(jgen.tridiagonal_system(16).A, B, method=name, **kw)
        with pytest.raises(err, match=msg):
            api.solve(s.A, B, method=name, device="cpu", **kw)
        return
    s, sj = tgen.poisson_system((15, 17)), jgen.poisson_system((15, 17))
    extra, jextra = {}, {}
    if kw:
        # "amg_cg mesh=": the sharded AMG pads the 255 rows to 256 inside,
        # on both sides
        from conjugategradient_tpu.parallel import make_mesh as j_mesh
        from conjugategradient_tpu_torch.parallel import make_mesh

        extra.update(mesh=make_mesh(8, devices=["cpu"] * 8), dtype=np.float64)
        jextra["mesh"] = j_mesh(8)
    if name == "sharded_cg":
        # 255 rows padded to 256 for the 8-shard meshes of both facades
        from conjugategradient_tpu.core.partition import pad_system as j_pad
        from conjugategradient_tpu.parallel import make_mesh as j_mesh
        from conjugategradient_tpu_torch.core.partition import pad_system
        from conjugategradient_tpu_torch.parallel import make_mesh

        (s, _), (sj, _) = pad_system(s, 8), j_pad(sj, 8)
        extra["mesh"], jextra["mesh"] = make_mesh(8, devices=["cpu"] * 8), j_mesh(8)
    B = np.stack([s.b, np.random.default_rng(6).standard_normal(s.n)], 1)
    opts = dict(method=name, tol=1e-10, norm="rel_l2")
    if name == "mg_gmres":
        opts["grid"] = (15, 17)
    if name == "idr":
        import jax

        extra["shadow"] = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (s.n, 4), jnp.float64))
    if name == "deflated_cg":
        from conjugategradient_tpu.solvers.deflation import make_deflation
        from conjugategradient_tpu_torch.convert import deflation_from_reference

        extra["deflation"] = deflation_from_reference(
            make_deflation(sj.A, k=8, dtype=np.float64), device="cpu")
    r, jr = api.solve(s.A, s.b, device="cpu", **opts, **extra), japi.solve(sj.A, sj.b, **opts,
                                                                           **jextra)
    assert r.converged and r.iterations == int(jr.iterations)
    assert np.abs(np.asarray(r.x) - np.asarray(jr.x)).max() <= 1e-10
    if name in _SINGLE_ONLY or kw:
        # a method with no (n, k) route, or (mesh=) no sharded block
        # carrier: both facades raise ValueError
        mesh_kw, jmesh_kw = (extra, jextra) if kw else ({}, {})
        with pytest.raises(ValueError, match="does not support"):
            api.solve(s.A, B, device="cpu", **opts, **mesh_kw)
        with pytest.raises(ValueError, match="does not support"):
            japi.solve(sj.A, B, **opts, **jmesh_kw)
        return
    r, jr = api.solve(s.A, B, device="cpu", **opts), japi.solve(sj.A, B, **opts)
    if name == "bicgstab":
        # on this Poisson block the JAX package's own BiCGStab column counts
        # move by one under a one-ulp change of B; the (n, k) BiCGStab routes
        # are held to it in tests/test_torch_krylov.py, where they do not
        assert bool(r.converged.all()) and bool(np.asarray(jr.converged).all())
        return
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(jr.iterations))
    assert np.abs(r.x.numpy() - np.asarray(jr.x)).max() <= 1e-10


def test_facade_refuses_mesh_and_unknown_methods():
    """mg_bicgstab with mesh= on the odd 1-D grid is the replicated
    single-device solve at the JAX facade's count; axes= with cg, an
    unknown method and refined on a non-DIA still raise."""
    from conjugategradient_tpu.parallel import make_mesh as j_mesh
    from conjugategradient_tpu_torch.parallel import make_mesh

    s = tgen.tridiagonal_system(16)
    opts = dict(method="mg_bicgstab", grid=(16,), tol=1e-10, norm="rel_l2")
    r = api.solve(s.A, s.b, mesh=make_mesh(2, devices=["cpu"] * 2), dtype=np.float64, **opts)
    jr = japi.solve(jgen.tridiagonal_system(16).A, s.b, mesh=j_mesh(2), **opts)
    assert r.converged and r.iterations == int(jr.iterations)
    assert np.abs(r.x.numpy() - np.asarray(jr.x)).max() <= 1e-10
    # axes= with a method that takes none: the JAX facade's TypeError
    with pytest.raises(TypeError, match="axes"):
        japi.solve(jgen.tridiagonal_system(16).A, s.b, method="cg", axes=("x",))
    with pytest.raises(TypeError, match="axes"):
        api.solve(s.A, s.b, method="cg", axes=("x",), device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        api.solve(s.A, s.b, method="nope", device="cpu")
    with pytest.raises(TypeError, match="DiaMatrix"):
        api.solve(object(), s.b, method="refined", device="cpu")
