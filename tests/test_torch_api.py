"""Generators, workloads, multi-RHS CG and the ``api.solve`` facade of the
port against the JAX package's, on the CPU.

The host generators and the workload table are copies: they must be
bit-identical and field-for-field equal.  ``cg_solve_multi`` in fp64 runs
the same per-column recurrence as the JAX package's, so the per-column
iteration counts are equal.  Every facade method the port does not have yet
raises ``NotImplementedError`` naming its ROADMAP item.
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
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item 12"):
        twl.get("cublas_flagship").build_rows(0, 10)


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
    for r in (plain, jac, fn):
        assert bool(r.converged.all())
        np.testing.assert_allclose(r.x.numpy(), plain.x.numpy(), rtol=1e-7, atol=1e-9)
    with pytest.raises(NotImplementedError, match="item 8"):
        as_multi_preconditioner(None)
    with pytest.raises(NotImplementedError, match="item 10"):
        bicgstab_solve_multi(A, B)


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
    with pytest.raises(NotImplementedError, match="item 8"):
        api.solve(s.A, B, method="mgcg", grid=(255,))


UNPORTED = {
    "bicgstab": "item 10", "gmres": "item 10", "fgmres": "item 10", "minres": "item 10",
    "idr": "item 10", "lsmr": "item 10", "cgnr": "item 10", "chebyshev": "item 10",
    "cacg": "item 10", "deflated_cg": "item 10", "native": "item 10", "auto": "item 10",
    "cheb_cg": "item 9", "sharded_cg": "item 12", "jacobi_cg": "item 9",
    "bjacobi_bicgstab": "item 9", "amg_cg": "item 9", "mg_gmres": "item 9",
}


@pytest.mark.parametrize("method", sorted(UNPORTED))
def test_unported_facade_methods_raise(method):
    s = tgen.tridiagonal_system(16)
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {UNPORTED[method]}"):
        api.solve(s.A, s.b, method=method, device="cpu")
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 {UNPORTED[method]}"):
        api.solve(s.A, np.stack([s.b, s.b], 1), method=method, device="cpu")


def test_facade_refuses_mesh_and_unknown_methods():
    s = tgen.tridiagonal_system(16)
    with pytest.raises(NotImplementedError, match="item 12"):
        api.solve(s.A, s.b, method="cg", mesh=object())
    with pytest.raises(ValueError, match="unknown method"):
        api.solve(s.A, s.b, method="nope", device="cpu")
    with pytest.raises(TypeError, match="DiaMatrix"):
        api.solve(object(), s.b, method="refined", device="cpu")
