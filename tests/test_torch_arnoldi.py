"""Krylov-Schur Arnoldi and the ``eigs`` facade of the port against the JAX
package, on the CPU.

The same host matrices (the generators make them bit-identical) go
through ``conjugategradient_tpu.solvers.arnoldi.arnoldi_eigs`` and the
port's ``solvers.arnoldi.arnoldi_eigs``, both starting from the same
``default_rng(seed)`` vector, and through both ``api.eigs``: fp64 values
within VALUES as sets, ``matvecs`` and ``restarts`` equal.  Shift-invert's
inner IDR(4) draws its shadow space differently in the two packages; its
inner solves reach 1e-10, so the outer counts still agree.  On the CPU
kernels #4 and #5 run their twins.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.solvers.arnoldi import arnoldi_eigs as j_arnoldi
from conjugategradient_tpu.solvers.arnoldi import gspmd_arnoldi_eigs as j_gspmd_arnoldi_eigs
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.solvers.arnoldi import arnoldi_eigs, gspmd_arnoldi_eigs

#: fp64 eigenvalues of the two packages, as sorted sets
VALUES = 1e-9
GRID = (16, 16)
JCD = jgen.convection_diffusion_matrix(GRID, eps=0.1)
TCD = tgen.convection_diffusion_matrix(GRID, eps=0.1)
CD_DENSE = tfmt.dia_to_dense(TCD).data
CD_EV = np.linalg.eigvals(CD_DENSE)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _sorted(v):
    return np.sort_complex(np.asarray(v))


def _same(rj, rt, values=VALUES):
    """The port's result is the JAX package's: values as sets, the counts,
    the flags, and true residuals at the reported ones."""
    assert len(rt.values) == len(rj.values)
    assert np.max(np.abs(_sorted(rt.values) - _sorted(rj.values))) <= values
    assert (rt.matvecs, rt.restarts) == (rj.matvecs, rj.restarts)
    assert (rt.converged, rt.inner_converged) == (rj.converged, rj.inner_converged)
    assert rt.vectors.shape == rj.vectors.shape


def _true_residuals(r, dense):
    return np.linalg.norm(dense @ r.vectors - r.vectors * r.values, axis=0)


@pytest.mark.parametrize("which,kw", [("LM", dict(k=6, tol=1e-10)),
                                      ("SR", dict(k=4, tol=1e-9, m=40))])
def test_plain_selections_match_jax(which, kw):
    rj = j_arnoldi(JCD, which=which, **kw)
    rt = arnoldi_eigs(TCD, which=which, device="cpu", **kw)
    assert rt.converged
    _same(rj, rt)
    if which == "LM":  # a complex spectrum, and free residual estimates
        assert np.any(np.abs(rt.values.imag) > 1e-6)
        true = _true_residuals(rt, CD_DENSE)
        assert true.max() < 1e-8
        assert np.abs(true - rt.residuals).max() < 1e-9


@pytest.mark.parametrize("inner,sigma,k", [("idr", 0.0, 4), ("bicgstab", -0.5, 3),
                                           ("gmres", -0.5, 3)])
def test_shift_invert_each_inner_method(inner, sigma, k):
    """sigma = 0 by IDR(4) (the JAX test's case, at most 3 restarts);
    BiCGStab and GMRES(40) at sigma = -0.5, left of the spectrum, where the
    shifted operator is definite enough for both."""
    kw = dict(k=k, sigma=sigma, tol=1e-8 if inner == "idr" else 1e-9, inner_method=inner)
    if inner == "idr":
        kw["m"] = 24
    rj = j_arnoldi(JCD, **kw)
    rt = arnoldi_eigs(TCD, device="cpu", **kw)
    assert rt.converged and rt.inner_converged
    _same(rj, rt)
    ref = CD_EV[np.argsort(np.abs(CD_EV - sigma))[:k]]
    assert np.max(np.abs(_sorted(rt.values) - _sorted(ref))) < 1e-8
    if inner == "idr":
        assert rt.restarts <= 3
    true = _true_residuals(rt, CD_DENSE)  # recomputed: the true residuals
    assert np.all(np.abs(rt.residuals - true) <= 1e-9 + 1e-6 * true)


def test_starved_inner_solve_flags():
    r = arnoldi_eigs(TCD, k=2, sigma=0.05, tol=1e-8, inner_max_iteration=2, device="cpu")
    assert not r.inner_converged


def test_shift_invert_fp32_default_inner_tol():
    """fp32 shift-invert with every inner default: the port's 1e-3 is a
    true residual its IDR(4) reaches (the JAX package's 1e-6 is not), so
    every inner solve converges, and the values hold to that level.  Each
    inner solve applies A - sigma I at least once."""
    r = api.eigs(TCD, k=4, sigma=0.0, dtype=torch.float32, device="cpu")
    assert r.converged and r.inner_converged
    assert r.inner_matvecs > r.matvecs
    ref = CD_EV[np.argsort(np.abs(CD_EV))[:4]]
    assert np.max(np.abs(_sorted(r.values) - _sorted(ref)) / np.abs(_sorted(ref))) < 1e-3


def test_non_finite_basis_raises():
    """A non-finite basis (an operator's NaN, or a diverged inner solve)
    raises a named error, not numpy's."""
    with pytest.raises(FloatingPointError, match="non-finite Arnoldi basis"):
        arnoldi_eigs(lambda v: v * float("nan"), k=2, n=16, device="cpu")


def test_symmetric_sanity_real_spectrum():
    A_t, A_j = tgen.poisson_system((12, 13)).A, jgen.poisson_system((12, 13)).A
    ev = np.sort(np.linalg.eigvalsh(tfmt.dia_to_dense(A_t).data))
    rj = j_arnoldi(A_j, k=3, which="LM", tol=1e-10)
    rt = arnoldi_eigs(A_t, k=3, which="LM", tol=1e-10, device="cpu")
    _same(rj, rt)
    assert np.max(np.abs(rt.values.imag)) < 1e-9
    assert np.max(np.abs(np.sort(rt.values.real) - ev[-3:])) < 1e-8


def test_csr_and_callable_operators():
    rj = j_arnoldi(jfmt.dia_to_csr(JCD), k=3, which="LM", tol=1e-9)
    rt = arnoldi_eigs(tfmt.dia_to_csr(TCD), k=3, which="LM", tol=1e-9, device="cpu")
    assert rt.converged
    _same(rj, rt)
    Ad = torch.from_numpy(CD_DENSE)
    rj_op = j_arnoldi(lambda v: jnp.asarray(CD_DENSE) @ v, k=3, which="LM", tol=1e-9, n=TCD.n)
    rt_op = arnoldi_eigs(lambda v: Ad @ v, k=3, which="LM", tol=1e-9, n=TCD.n, device="cpu")
    _same(rj_op, rt_op)
    assert np.max(np.abs(_sorted(rt.values) - _sorted(rt_op.values))) < 1e-7


def test_validation_errors():
    with pytest.raises(ValueError, match="pass n="):
        arnoldi_eigs(lambda v: v, k=2)
    with pytest.raises(ValueError, match="must be <"):
        arnoldi_eigs(tgen.poisson_system((3,)).A, k=3)
    with pytest.raises(ValueError, match="unknown which"):
        arnoldi_eigs(TCD, k=2, which="XX", device="cpu")
    with pytest.raises(ValueError, match="must be >= k"):
        arnoldi_eigs(TCD, k=4, m=5)
    with pytest.raises(ValueError, match="unknown inner_method"):
        arnoldi_eigs(TCD, k=2, sigma=0.1, inner_method="cg", device="cpu")
    from conjugategradient_tpu_torch.parallel import make_mesh

    m3 = make_mesh(3, devices=["cpu"] * 3)  # 256 rows do not divide over 3 shards
    with pytest.raises(ValueError, match="divide"):
        arnoldi_eigs(TCD, k=2, basis_sharding=(m3, m3.axis))
    with pytest.raises(ValueError, match="needs a mesh"):
        gspmd_arnoldi_eigs(TCD, k=2)
    with pytest.raises(ValueError, match="needs a mesh"):
        j_gspmd_arnoldi_eigs(JCD, k=2)


@pytest.mark.parametrize("which", ["LM", "SM"])
def test_lucky_breakdown_identity(which):
    """The identity breaks down at the first step: deflate-restarts and
    exact unit eigenvalues, with no spurious zeros under SM."""
    n = 50
    I_t = tfmt.DiaMatrix(np.ones((1, n)), (0,), (n, n))
    I_j = jfmt.DiaMatrix(np.ones((1, n)), (0,), (n, n))
    rj = j_arnoldi(I_j, k=3, which=which, tol=1e-10)
    rt = arnoldi_eigs(I_t, k=3, which=which, tol=1e-10, device="cpu")
    assert rt.converged
    _same(rj, rt, values=0.0)
    assert np.max(np.abs(rt.values - 1.0)) < 1e-12
    assert np.max(rt.residuals) < 1e-10


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_eigs_auto_routes_nonsymmetric_to_arnoldi():
    rj = japi.eigs(JCD, k=3, which="LM", tol=1e-9)
    rt = api.eigs(TCD, k=3, which="LM", tol=1e-9, device="cpu")
    assert rt.converged
    _same(rj, rt)


def test_eigs_auto_routes_spd_to_lobpcg():
    """The square Laplacian's multiplicity-2 pairs need the block solver:
    auto takes LOBPCG (restarts = iterations, matvecs 3k an iteration).
    The two packages draw different starting blocks, so the values agree
    to the tolerance's reach and the counts are not compared."""
    A_t, A_j = tgen.poisson_system((12, 12)).A, jgen.poisson_system((12, 12)).A
    ev = np.sort(np.linalg.eigvalsh(tfmt.dia_to_dense(A_t).data))
    kw = dict(k=4, which="SM", tol=1e-9, dtype=np.float64, max_iterations=400)
    rj = japi.eigs(A_j, **kw)
    rt = api.eigs(A_t, device="cpu", **kw)
    assert rt.converged and rj.converged
    assert np.max(np.abs(rt.values.imag)) == 0.0
    assert np.max(np.abs(np.sort(rt.values.real) - ev[:4])) < 1e-6
    assert np.max(np.abs(rt.values - rj.values)) < 1e-6
    assert rt.matvecs == 3 * 4 * rt.restarts


def test_eigs_sigma_and_forced_method():
    kw = dict(k=2, sigma=0.1, tol=1e-9)
    rj, rt = japi.eigs(JCD, **kw), api.eigs(TCD, device="cpu", **kw)
    _same(rj, rt)
    ref = np.sort_complex(CD_EV[np.argsort(np.abs(CD_EV - 0.1))[:2]])
    assert np.max(np.abs(_sorted(rt.values) - ref)) < 1e-7
    A_t, A_j = tgen.poisson_system((12, 13)).A, jgen.poisson_system((12, 13)).A
    kw = dict(k=2, which="LM", method="arnoldi", tol=1e-9)
    rj, rt = japi.eigs(A_j, **kw), api.eigs(A_t, device="cpu", **kw)
    assert rt.converged
    _same(rj, rt)


def test_eigs_symmetric_indefinite_not_misrouted():
    """Helmholtz on (12, 13) at shift 3: auto must not take LOBPCG (its
    algebraic ends are the wrong modes for SM); Arnoldi and shift-invert
    find the three smallest in magnitude."""
    A_t = tgen.helmholtz_matrix((12, 13), shift=3.0)
    A_j = jgen.helmholtz_matrix((12, 13), shift=3.0)
    ev = np.linalg.eigvalsh(tfmt.dia_to_dense(A_t).data)
    assert ev[0] < 0 < ev[-1]
    ref = np.sort(ev[np.argsort(np.abs(ev))[:3]])
    rj = japi.eigs(A_j, k=3, which="SM", tol=1e-8)
    rt = api.eigs(A_t, k=3, which="SM", tol=1e-8, device="cpu")
    _same(rj, rt)
    assert np.max(np.abs(np.sort(rt.values.real) - ref)) < 5e-6
    r0 = api.eigs(A_t, k=3, sigma=0.0, tol=1e-9, device="cpu")
    assert r0.converged and r0.inner_converged
    assert np.max(np.abs(np.sort(r0.values.real) - ref)) < 1e-8


def test_eigs_fp32_default_tol_converges():
    """All defaults (LOBPCG in fp32): the dtype-aware tol 1e-5 is reached
    well inside the iteration budget."""
    r = api.eigs(tgen.poisson2d_matrix(24, 24), k=4, device="cpu")
    assert r.converged
    assert r.restarts < 200
    ev = np.sort(np.linalg.eigvalsh(tfmt.dia_to_dense(tgen.poisson2d_matrix(24, 24)).data))
    assert np.max(np.abs(np.sort(r.values.real) - ev[-4:])) < 1e-4 * ev[-1]


class _Huge:
    """A stub past the probe's cap: a shape and nothing to multiply."""

    shape = (4_000_001, 4_000_001)


def test_eigs_refusals_and_probe_cap():
    with pytest.raises(ValueError, match="unknown eigs method"):
        api.eigs(TCD, method="dense")
    with pytest.raises(ValueError, match="unknown which"):
        api.eigs(TCD, which="XX")
    from conjugategradient_tpu_torch.parallel import make_mesh

    r = api.eigs(TCD, k=2, mesh=make_mesh(2, devices=["cpu"] * 2))
    one = api.eigs(TCD, k=2, device="cpu")
    assert r.converged and (r.matvecs, r.restarts) == (one.matvecs, one.restarts)
    assert np.abs(np.sort_complex(r.values) - np.sort_complex(one.values)).max() < 1e-10
    for eigs in (japi.eigs, lambda A, **kw: api.eigs(A, device="cpu", **kw)):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with pytest.raises(ValueError, match="pass n="):
                eigs(_Huge(), k=2)
        assert any(issubclass(x.category, RuntimeWarning) and "probe cap" in str(x.message)
                   for x in w)
