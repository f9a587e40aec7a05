"""Deflated CG of the port (``solvers.deflation``) against the JAX package's,
on the CPU.

``outlier_system`` bit for bit; the Lanczos probe (orthonormal, and its
tridiagonal the Rayleigh quotient; from the JAX package's start vector its
Ritz values equal the JAX package's); the Galerkin triple (AW, E, chol_E)
from the port's fp64 product against the JAX package's double-float one on
the same basis; ``deflated_cg_solve`` over a JAX deflation carried across
(``convert.deflation_from_reference``): the JAX count and x; the port's own
deflation cutting iterations, amortising over a sequence and composing
with a Jacobi M; ``refined_solve(deflation=)`` on the host, device-residual
and grid routes; the facade, sharded def-CG (``with_axis``) on 8-shard
meshes; the refusals."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops import dd as jdd
from conjugategradient_tpu.ops.spmv import as_operator as j_as_operator
from conjugategradient_tpu.solvers import deflation as jdefl
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu.solvers.refine import refined_solve as j_refined
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import deflation_from_reference
from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.deflation import (
    Deflation,
    deflated_cg_solve,
    deflation_from_basis,
    galerkin_products,
    lanczos_basis,
    make_deflation,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve

#: the same recurrence in fp64: x within this fraction of ||x||
X_REL = 1e-10
#: E from the fp64 product against the JAX package's double-float (about
#: 2^-48 relative) product on the same fp32 basis: 9e-15 measured
E_REL = 1e-12
#: the k smallest Ritz values of the same fp64 probe (same start vector),
#: within this fraction of the largest: the outliers' values (about 1e-5)
#: carry the probe's fp64 rounding of about eps ||A|| (8e-15 measured)
RITZ_ABS = 1e-12
POL = dict(tol=1e-8, norm="rel_l2", max_iteration=100_000)
N = 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def outlier():
    s, sj = tgen.outlier_system(N, band=16), jgen.outlier_system(N, band=16)
    return s, sj, s.A.device_put(device="cpu")


@pytest.fixture(scope="module")
def jdef32(outlier):
    """The JAX package's fp32 deflation (AW by its dd SpMV)."""
    return jdefl.make_deflation(outlier[1].A, k=8, m=48)


@pytest.fixture(scope="module")
def jdef64(outlier):
    """The JAX package's fp64 deflation at the facade's defaults."""
    return jdefl.make_deflation(outlier[1].A, k=8, dtype=np.float64)


def _v0(n, dtype=np.float64):
    """The JAX package's Lanczos start vector (seed 0)."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,), dtype))


def _rel(x, ref) -> float:
    x = (x.numpy() if torch.is_tensor(x) else np.asarray(x)).reshape(-1)
    ref = np.asarray(ref).reshape(-1)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("kw", [dict(n=4096), dict(n=1000, band=8, n_outliers=2, scale=1e-2,
                                                   seed=3, dtype=np.float32)])
def test_outlier_system_is_bit_identical(kw):
    s, sj = tgen.outlier_system(**kw), jgen.outlier_system(**kw)
    assert s.A.offsets == sj.A.offsets and s.A.data.dtype == np.asarray(sj.A.data).dtype
    np.testing.assert_array_equal(s.A.data, np.asarray(sj.A.data))
    np.testing.assert_array_equal(s.b, np.asarray(sj.b))
    np.testing.assert_array_equal(s.x0, np.asarray(sj.x0))


def test_lanczos_basis_and_ritz_values_match_jax(outlier):
    s, sj, A_dev = outlier
    m, k = 32, 8
    V, alphas, betas = lanczos_basis(as_operator(A_dev), N, m, torch.float64, device="cpu")
    V = V.numpy()
    assert np.abs(V @ V.T - np.eye(m)).max() < 1e-10
    AV = np.stack([oracle.spmv(s.A, V[j]) for j in range(m)])
    a, b_ = alphas.numpy(), betas.numpy()[:-1]
    assert np.abs(V @ AV.T - (np.diag(a) + np.diag(b_, 1) + np.diag(b_, -1))).max() < 1e-9
    # from the JAX package's start vector: the same Ritz values
    _, at, bt = lanczos_basis(as_operator(A_dev), N, m, torch.float64, device="cpu",
                              v0=_v0(N))
    _, aj, bj = jax.jit(lambda A_: jdefl.lanczos_basis(
        lambda v: j_as_operator(A_)(v), N, m, jnp.float64))(sj.A.device_put(np.float64))
    ritz = lambda a, b: np.linalg.eigvalsh(np.diag(a) + np.diag(b[:-1], 1) + np.diag(b[:-1], -1))
    rt, rj = ritz(at.numpy(), bt.numpy()), ritz(np.asarray(aj), np.asarray(bj))
    assert np.abs(rt[:k] - rj[:k]).max() <= RITZ_ABS * rj[-1]


def test_galerkin_triple_matches_the_jax_dd_values(outlier, jdef32):
    s, sj, _ = outlier
    jd = jdef32
    W = torch.from_numpy(np.array(jd.W))
    d = deflation_from_basis(s.A, W, device="cpu")
    AW64, E = galerkin_products(s.A, W, device="cpu")
    ddm = jdd.dd_split_matrix(sj.A)
    zero = jnp.zeros(N, jnp.float32)
    cols = [jdd.dd_spmv(ddm, (jd.W[:, j], zero)) for j in range(8)]
    AW_dd = np.stack([np.asarray(h, np.float64) + np.asarray(l, np.float64) for h, l in cols], 1)
    E_dd = np.asarray(jd.W, np.float64).T @ AW_dd
    assert np.abs(E - E_dd).max() <= E_REL * np.abs(E_dd).max()
    # AW is the fp32 rounding of the same value; the equilibrated factor
    # and the scale come out of the same host fp64 arithmetic
    np.testing.assert_array_equal(d.AW.numpy(), np.asarray(jd.AW))
    np.testing.assert_array_equal(d.scale.numpy(), np.asarray(jd.scale))
    np.testing.assert_allclose(d.chol_E.numpy(), np.asarray(jd.chol_E), rtol=0,
                               atol=4 * np.finfo(np.float32).eps)
    assert set(d.setup_s) == {"aw", "equilibration"}


def test_deflated_cg_over_a_jax_deflation_equals_jax(outlier, jdef64):
    s, sj, A_dev = outlier
    jd = jdef64
    d = deflation_from_reference(jd, device="cpu")
    assert isinstance(d, Deflation) and d.k == 8 and d.W.dtype == torch.float64
    x0 = np.random.default_rng(2).standard_normal(N)
    for guess in (None, x0):
        r = deflated_cg_solve(A_dev, torch.from_numpy(s.b),
                              None if guess is None else torch.from_numpy(guess),
                              policy=ConvergencePolicy(**POL), deflation=d, precise_dot=True)
        jr = jdefl.deflated_cg_solve(sj.A.device_put(np.float64), jnp.asarray(sj.b),
                                     None if guess is None else jnp.asarray(guess),
                                     policy=JPolicy(**POL), deflation=jd, precise_dot=True)
        assert r.converged and bool(jr.converged)
        assert r.iterations == int(jr.iterations)
        assert _rel(r.x, jr.x) <= X_REL


def test_deflation_cuts_iterations_amortises_and_takes_a_jacobi_m(outlier):
    """The port's own probe (its seeded start vector): def-CG at most half
    plain CG's count on the outlier spectrum, the true residual met; over
    five seeded right-hand sides the probe's products plus the deflated
    iterations beat plain CG's total; with a Jacobi M fewer iterations than
    Jacobi PCG."""
    s, _, A_dev = outlier
    m = 48
    d = make_deflation(s.A, k=8, m=m, dtype=np.float64, device="cpu")
    assert set(d.setup_s) == {"lanczos", "eigh", "aw", "equilibration"}
    pol = ConvergencePolicy(**POL)
    b = torch.from_numpy(s.b)
    plain = cg_solve(A_dev, b, policy=pol, precise_dot=True)
    dres = deflated_cg_solve(A_dev, b, policy=pol, deflation=d, precise_dot=True)
    assert dres.converged and dres.iterations <= plain.iterations // 2
    assert np.linalg.norm(s.b - oracle.spmv(s.A, dres.x.numpy())) / np.linalg.norm(s.b) < 1e-7
    rng = np.random.default_rng(7)
    total_plain, total_defl = 0, m
    for _ in range(5):
        bk = torch.from_numpy(rng.standard_normal(N))
        total_plain += cg_solve(A_dev, bk, policy=pol, precise_dot=True).iterations
        rk = deflated_cg_solve(A_dev, bk, policy=pol, deflation=d, precise_dot=True)
        assert rk.converged
        total_defl += rk.iterations
    assert total_defl < total_plain
    inv = torch.from_numpy(1.0 / formats.dia_diagonal(s.A))
    M = lambda r: inv * r
    pj = cg_solve(A_dev, b, policy=pol, M=M, precise_dot=True)
    dj = deflated_cg_solve(A_dev, b, policy=pol, deflation=d, M=M, precise_dot=True)
    assert dj.converged and dj.iterations < pj.iterations
    assert np.linalg.norm(s.b - oracle.spmv(s.A, dj.x.numpy())) / np.linalg.norm(s.b) < 1e-7


@pytest.mark.parametrize("route", ["host residual", "device residual", "grid"])
def test_refined_solve_with_deflation_on_every_route(route, outlier, jdef32):
    """fp32 inner def-CG over the JAX package's fp32 deflation carried
    across, to an absolute fp64 tolerance: the true residual met and fewer
    inner iterations than undeflated refinement.  Host route: the JAX
    package's outer and inner counts; device residual (fp64 on the device
    here, double-float in the JAX package): the JAX outer count; grid
    (deflated MGCG on 31^2 Poisson, whose low modes the V-cycle already
    takes, so no cut is asked): converged with the JAX outer count."""
    if route == "grid":
        g = (31, 31)
        s, sj = tgen.poisson_system(g), jgen.poisson_system(g)
        kw = dict(grid=g, tol=1e-9)
        jd = jdefl.make_deflation(sj.A, k=4, m=32)
    else:
        s, sj, _ = outlier
        kw = dict(tol=1e-9, device_residual=route == "device residual")
        jd = jdef32
    d = deflation_from_reference(jd, device="cpu")
    base = refined_solve(s.A, s.b, device="cpu", **kw)
    r = refined_solve(s.A, s.b, deflation=d, device="cpu", **kw)
    jr = j_refined(sj.A, sj.b, deflation=jd, use_pallas=False, **kw)
    for res in (base, r):
        assert res.converged
        assert np.linalg.norm(s.b - oracle.spmv(s.A, res.x)) < kw["tol"]
    assert jr.converged and r.outer_iterations == jr.outer_iterations
    if route == "host residual":
        assert r.inner_iterations == jr.inner_iterations
    if route != "grid":
        assert r.inner_iterations < base.inner_iterations
    with pytest.raises(TypeError, match="must be a solvers.deflation.Deflation"):
        refined_solve(s.A, s.b, deflation=object(), device="cpu")


def test_facade_deflated_cg_and_the_refusals(outlier, jdef64):
    s, sj, _ = outlier
    jd = jdef64
    opts = dict(method="deflated_cg", tol=1e-10, norm="rel_l2")
    r = api.solve(s.A, s.b, device="cpu", deflation=deflation_from_reference(jd, "cpu"), **opts)
    jr = japi.solve(sj.A, sj.b, **opts)  # builds the same deflation (k=8, seed 0)
    assert r.converged and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL
    own = api.solve(s.A, s.b, device="cpu", k=8, m=32, **opts)
    assert own.converged and own.iterations < cg_solve(
        s.A, torch.from_numpy(s.b), policy=ConvergencePolicy(tol=1e-10, norm="rel_l2")).iterations
    with pytest.raises(ValueError, match="requires deflation"):
        deflated_cg_solve(s.A, torch.from_numpy(s.b))
    data = np.linspace(-1.0, 1.0, 256)[None, :]  # an indefinite diagonal
    with pytest.raises(ValueError, match="not positive definite"):
        make_deflation(formats.DiaMatrix(data, (0,), (256, 256)), k=4, m=16, dtype=np.float64,
                       device="cpu")
    # with_axis: sharded def-CG on 8-shard meshes, against the JAX package's
    from conjugategradient_tpu.parallel import make_mesh as j_mesh
    from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve as j_sharded
    from conjugategradient_tpu_torch.parallel import make_mesh
    from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_solve

    pol = dict(tol=1e-10, norm="rel_l2", max_iteration=5000)
    rs = sharded_cg_solve(s.A, s.b, policy=ConvergencePolicy(**pol),
                          mesh=make_mesh(8, devices=["cpu"] * 8),
                          deflation=deflation_from_reference(jd, "cpu"))
    jrs = j_sharded(sj.A, sj.b, policy=JPolicy(**pol), mesh=j_mesh(8), deflation=jd)
    assert rs.converged and rs.iterations == int(jrs.iterations) == r.iterations
    assert _rel(rs.x, jrs.x) <= X_REL
    with pytest.raises(TypeError, match="sharded deflation"):
        make_deflation(s.A, k=2, m=8, dtype=np.float64, device="cpu").with_axis("x")
