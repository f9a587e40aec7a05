"""Least squares and the compensated reductions of the port against the JAX
package, on the CPU.

CGNR (``solvers.cgnr``) on the nonsymmetric banded system, on DIA and on
its variable-coefficient stencil form (whose transpose negates the
shifts); LSMR (``solvers.lsmr``) on over- and underdetermined, damped,
square and warm-started systems against the JAX package and scipy, the
linf refusal, and ``api.solve(method="auto")`` on a rectangular A; the
rectangular CSR placed and multiplied by the port's products; and the
precision helpers ``dd_dot``, ``kahan_sum`` (bit for bit on fp32) and
``promote_dot``.  fp64 iteration counts are equal and x within X_REL of
||x||; inputs come from the generators and numpy seeds."""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.io import from_scipy as j_from_scipy
from conjugategradient_tpu.ops import precision as jprec
from conjugategradient_tpu.solvers.cgnr import cgnr_solve as j_cgnr
from conjugategradient_tpu.solvers.lsmr import lsmr_solve as j_lsmr
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import formats
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.io import from_scipy
from conjugategradient_tpu_torch.ops import precision as tprec
from conjugategradient_tpu_torch.ops.spmv import spmv
from conjugategradient_tpu_torch.solvers.cgnr import cgnr_solve
from conjugategradient_tpu_torch.solvers.lsmr import lsmr_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same recurrence in fp64: x within this fraction of ||x||
X_REL = 1e-10
#: LSMR against scipy's lsmr at atol = btol = 1e-14 (the JAX package's own
#: test bound: two different stopping rules on one least-squares solution)
SCIPY_REL = 1e-8
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=4000)
#: see _same
RES_AGREE = 0.25


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rel(x, ref) -> float:
    x = x.numpy() if torch.is_tensor(x) else np.asarray(x)
    ref = np.asarray(ref)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def _same(r, jr, residual=True):
    """Equal fp64 counts, x within X_REL, converged flags equal, and the
    re-evaluated residuals within RES_AGREE of the tolerance (two fp64
    evaluations of ||A^T r|| near the solution differ by rounding noise of
    about 1e-11 relative; 0.07 of the 1e-10 tolerance measured).  A warm
    start at the optimum has a residual relative to ||A^T (b - A x0)||,
    itself rounding noise, so ``residual=False`` skips that comparison."""
    assert r.iterations == int(jr.iterations)
    assert r.converged == bool(jr.converged)
    assert _rel(r.x, jr.x) <= X_REL
    if residual:
        assert abs(float(r.residual) - float(jr.residual)) <= RES_AGREE * POL["tol"]


def _overdetermined(m=500, n=200, seed=0):
    """The JAX package's test system: 5% random entries plus the identity
    on the first n rows, and a seeded b (inconsistent)."""
    S = sp.random(m, n, density=0.05, random_state=seed, format="csr")
    S = (S + sp.vstack([sp.eye(n), sp.csr_matrix((m - n, n))])).tocsr()
    return S, np.random.default_rng(seed).standard_normal(m)


def _underdetermined():
    m, n = 200, 500
    S = sp.random(m, n, density=0.05, random_state=1, format="csr")
    S = (S + sp.hstack([sp.eye(m), sp.csr_matrix((m, n - m))])).tocsr()
    return S, np.random.default_rng(1).standard_normal(m)


def test_cgnr_matches_jax_on_the_nonsymmetric_band():
    s, sj = tgen.nonsymmetric_banded_system(1024, 8), jgen.nonsymmetric_banded_system(1024, 8)
    r = cgnr_solve(s.A, torch.from_numpy(s.b), policy=ConvergencePolicy(**POL))
    jr = j_cgnr(sj.A, jnp.asarray(sj.b), policy=JPolicy(**POL))
    assert r.converged
    _same(r, jr)
    # the returned residual is the true ||b - A x|| / ||b||, not A^T r's
    true = np.linalg.norm(s.b - spmv(s.A, r.x).numpy()) / np.linalg.norm(s.b)
    np.testing.assert_allclose(float(r.residual), true, rtol=1e-6)
    f = api.solve(s.A, s.b, method="cgnr", device="cpu", **{k: POL[k] for k in ("tol", "norm")})
    assert f.iterations == r.iterations and _rel(f.x, r.x) == 0.0


def test_cgnr_on_a_stencil_runs_its_transpose_with_negated_shifts():
    s = tgen.convection_diffusion_system((15, 15), eps=0.5)
    st = formats.dia_to_stencil(s.A, (15, 15))
    stT = formats.transpose(st)
    assert isinstance(stT, formats.StencilMatrix)
    assert sorted(stT.shifts) == sorted(tuple(-d for d in sh) for sh in st.shifts)
    b = torch.from_numpy(s.b).reshape(15, 15)
    rs = cgnr_solve(st, b, policy=ConvergencePolicy(**POL))
    rd = cgnr_solve(s.A, b.reshape(-1), policy=ConvergencePolicy(**POL))
    assert rs.converged and rs.x.shape == (15, 15)
    assert rs.iterations == rd.iterations
    assert _rel(rs.x.reshape(-1), rd.x) <= X_REL


@pytest.mark.parametrize("case", ["overdetermined", "underdetermined", "damped", "square",
                                  "warm start"])
def test_lsmr_matches_jax_and_scipy(case):
    damp, x0 = 0.0, None
    if case == "square":
        s = tgen.nonsymmetric_banded_system(1024, 8)
        S, b = formats.to_sparse_coo(s.A), s.b
        A, Aj = s.A, jgen.nonsymmetric_banded_system(1024, 8).A
        S = sp.csr_matrix(S.to_dense().numpy())
    else:
        S, b = _underdetermined() if case == "underdetermined" else _overdetermined(
            seed={"overdetermined": 0, "damped": 2, "warm start": 3}[case])
        A, Aj = from_scipy(S), j_from_scipy(S)
    if case == "damped":
        damp = 0.5
    x_ref = spla.lsmr(S, b, damp=damp, atol=1e-14, btol=1e-14)[0]
    if case == "warm start":
        x0 = x_ref
    r = lsmr_solve(A, torch.from_numpy(b), None if x0 is None else torch.from_numpy(x0),
                   policy=ConvergencePolicy(**POL), damp=damp)
    jr = j_lsmr(Aj, jnp.asarray(b), None if x0 is None else jnp.asarray(x0),
                policy=JPolicy(**POL), damp=damp)
    _same(r, jr, residual=case != "warm start")
    assert r.x.shape == (S.shape[1],)
    assert _rel(r.x, x_ref) < SCIPY_REL
    if case == "overdetermined":
        # least-squares optimality: ||A^T r|| tiny while ||r|| is not
        res = b - S @ r.x.numpy()
        assert np.linalg.norm(S.T @ res) < 1e-8 * np.linalg.norm(S.T @ b)
        assert np.linalg.norm(res) > 1.0


def test_lsmr_refuses_linf_and_auto_routes_a_rectangular_matrix():
    S, b = _overdetermined(seed=4)
    with pytest.raises(ValueError, match="use norm='l2' or 'rel_l2'"):
        lsmr_solve(from_scipy(S), torch.from_numpy(b), policy=ConvergencePolicy(norm="linf"))
    opts = dict(method="auto", tol=1e-10, norm="rel_l2")
    r = api.solve(from_scipy(S), b, device="cpu", **opts)
    jr = japi.solve(j_from_scipy(S), b, **opts)
    _same(r, jr)
    with pytest.raises(ValueError, match="does not support"):
        api.solve(from_scipy(S), np.stack([b, b], 1), device="cpu", **opts)


def test_a_rectangular_csr_places_and_multiplies():
    S, _ = _overdetermined(m=300, n=120, seed=5)
    A = from_scipy(S)
    x = np.random.default_rng(5).standard_normal(120)
    dev = A.device_put(torch.float64, "cpu")
    assert dev.shape == (300, 120) and dev.indptr.shape == (301,)
    np.testing.assert_allclose(spmv(dev, torch.from_numpy(x)).numpy(), S @ x, rtol=1e-13,
                               atol=1e-13)
    At = formats.transpose(A)
    assert At.shape == (120, 300)
    y = np.random.default_rng(6).standard_normal(300)
    np.testing.assert_allclose(spmv(At.device_put(device="cpu"), torch.from_numpy(y)).numpy(),
                               S.T @ y, rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("n", [1, 7, 4097])
def test_compensated_reductions_match_jax(n):
    """``dd_dot`` and ``kahan_sum`` bit for bit on fp32 (the same
    elementwise error-free transforms in the same tree order);
    ``promote_dot`` (a plain dot, whose summation order differs between
    the two libraries) within n eps of sum |a b|; ``dd_dot`` near the
    fp64 value."""
    rng = np.random.default_rng(n)
    a = (rng.standard_normal(n) * 10.0 ** rng.uniform(-3, 3, n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    ta, tb, ja, jb = torch.from_numpy(a), torch.from_numpy(b), jnp.asarray(a), jnp.asarray(b)
    assert tprec.dd_dot(ta, tb).numpy() == np.asarray(jprec.dd_dot(ja, jb))
    assert tprec.kahan_sum(ta).numpy() == np.asarray(jprec.kahan_sum(ja))
    assert tprec.dd_sum(ta, tb).numpy() == np.asarray(jprec.dd_sum(ja, jb))
    exact = float(a.astype(np.float64) @ b.astype(np.float64))
    scale = float(np.abs(a.astype(np.float64) * b).sum())
    assert abs(float(tprec.dd_dot(ta, tb)) - exact) <= 4 * np.finfo(np.float32).eps * abs(exact) \
        + 1e-12 * scale
    bf = torch.from_numpy(a).to(torch.bfloat16)
    pd = float(tprec.promote_dot(bf, tb))
    jpd = float(jprec.promote_dot(jnp.asarray(a, jnp.bfloat16), jb))
    assert abs(pd - jpd) <= n * np.finfo(np.float32).eps * scale
