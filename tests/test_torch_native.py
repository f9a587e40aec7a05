"""The port's host kit (``conjugategradient_tpu_torch.native``, its own copy
of csrkit) against the JAX package's kit and the port's numpy paths, on
the CPU.

The ten cases of ``tests/test_native.py``, each held three ways: the
port's kit against the JAX kit, and against the port's numpy conversions,
oracle and Python aggregation loop.  Conversions, halo ranges, the
generator and the aggregation do no rounding that the build could change,
so they are equal exactly; the SpMV and CG may differ in the last bits
(the JAX kit builds with ``-march=native``, which contracts a*b+c into an
FMA; the port's does not), so x is held within CG_REL and the iteration
counts and flags are equal.  Both kits run in this one process, on the
same OpenMP thread count, so their reductions split the rows alike.
``api.solve(method="native")`` equals the JAX facade's; where there is no
host compiler the kit reports itself unavailable and the numpy paths run.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conjugategradient_tpu import api as japi
from conjugategradient_tpu import native as jnative
from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.partition import RowBlockPartition as JPartition
from conjugategradient_tpu.core.partition import halo_ranges_from_csr as j_halo
from conjugategradient_tpu_torch import api, native
from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.partition import RowBlockPartition, halo_ranges_from_csr
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.precond import amg

#: x of the two kits' CG (the last bits of the FMA contraction, carried
#: through the iterations), relative to max |x|
CG_REL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def _kits():
    assert native.available(), "the port's kit did not build"
    assert jnative.available(), "the JAX kit did not build"


def _csr_pair(A):
    """The same host matrix as a CSR of each package."""
    c = formats.dia_to_csr(A)
    return c, jformats.CsrMatrix(c.data, c.indices, c.indptr, c.row_ids, c.shape)


def _same_csr(a, b):
    for f in ("data", "indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)), f)
    assert tuple(a.shape) == tuple(b.shape)


def _coo_to_csr():
    rng = np.random.default_rng(3)
    nnz, n = 300, 40
    rows = rng.integers(0, n, nnz).astype(np.int32)
    cols = rng.integers(0, n, nnz).astype(np.int32)
    vals = rng.normal(size=nnz)
    coo = formats.CooMatrix(vals, rows, cols, (n, n))
    got = native.coo_to_csr(coo)
    # the same sort and the same sums as the JAX kit: equal exactly
    _same_csr(got, jnative.coo_to_csr(jformats.CooMatrix(vals, rows, cols, (n, n))))
    # numpy sums a repeated (row, col) in input order, the kit in its sort's
    # order: the structure is equal, the values within rounding
    ref = formats.coo_to_csr(coo)
    for f in ("indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(ref, f))
    np.testing.assert_allclose(got.data, ref.data, rtol=0, atol=1e-14 * np.abs(ref.data).max())
    # no repeated entry (a CSR's own COO): the numpy arrays exactly
    c = formats.dia_to_csr(tgen.banded_sin_matrix(200, 12))
    _same_csr(native.coo_to_csr(formats.csr_to_coo(c)), c)


def _spmv():
    A = tgen.banded_sin_matrix(120, 10)
    c, cj = _csr_pair(A)
    x = np.sin(np.arange(120.0))
    y = native.csr_spmv(c, x)
    scale = np.abs(y).max()
    assert np.abs(y - jnative.csr_spmv(cj, x)).max() <= CG_REL * scale
    assert np.abs(y - oracle.spmv(c, x)).max() <= CG_REL * scale


def _halo_ranges():
    c, cj = _csr_pair(tgen.banded_sin_matrix(97, 12))
    part = RowBlockPartition.equal(97, 4)
    got = native.halo_ranges(c, part)
    assert got == halo_ranges_from_csr(c, part)
    assert got == jnative.halo_ranges(cj, JPartition.equal(97, 4)) == j_halo(cj, JPartition.equal(97, 4))


def _csr_to_dia_and_ell():
    c, cj = _csr_pair(tgen.banded_sin_matrix(64, 8))
    dia, ref, jref = native.csr_to_dia(c), formats.csr_to_dia(c), jnative.csr_to_dia(cj)
    np.testing.assert_array_equal(dia.data, ref.data)
    np.testing.assert_array_equal(dia.data, np.asarray(jref.data))
    assert dia.offsets == ref.offsets == tuple(jref.offsets) and dia.shape == ref.shape
    ell, ref, jref = native.csr_to_ell(c), formats.csr_to_ell(c), jnative.csr_to_ell(cj)
    for f in ("data", "cols"):
        np.testing.assert_array_equal(getattr(ell, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(ell, f), np.asarray(getattr(jref, f)))
    np.testing.assert_array_equal(ell.cols[:, 0], np.arange(64))
    with pytest.raises(ValueError, match="exceeds ELL width"):
        native.csr_to_ell(c, k=3)
    with pytest.raises(ValueError, match="outside the requested diagonal set"):
        native.csr_to_dia(c, offsets=(0,))


def _banded_sin_generator():
    a = native.banded_sin_dia(80, 10)
    b = tgen.banded_sin_system(80, 10).A
    np.testing.assert_array_equal(a.data, b.data)
    np.testing.assert_array_equal(a.data, np.asarray(jnative.banded_sin_dia(80, 10).data))
    assert a.offsets == b.offsets


def _cg_pair(c, cj, b, x0=None, **kw):
    got = native.cg(c, b, x0, **kw)
    ref = jnative.cg(cj, b, x0, **kw)
    assert got.converged == ref.converged and got.iterations == ref.iterations
    assert np.abs(got.x - ref.x).max() <= CG_REL * np.abs(ref.x).max()
    return got


def _cg_matches_oracle():
    s = tgen.banded_sin_system(2048, 16)
    c, cj = _csr_pair(s.A)
    got = _cg_pair(c, cj, s.b, s.x0, tol=1e-8, norm="l2")
    ref = oracle.cg(s.A, s.b, s.x0, tol=1e-8, norm="l2")
    assert got.converged and abs(got.iterations - ref.iterations) <= 2
    np.testing.assert_allclose(got.x, ref.x, rtol=1e-8, atol=1e-10)


def _cg_nonconvergence_policy():
    s = tgen.tridiagonal_system(512)
    c, cj = _csr_pair(s.A)
    with pytest.raises(oracle.NotConvergedError):
        native.cg(c, s.b, tol=1e-30, max_iteration=10)
    res = _cg_pair(c, cj, s.b, tol=1e-30, max_iteration=10, raise_on_divergence=False)
    assert not res.converged and res.iterations == 10


def _cg_linf_and_rel_norms():
    s = tgen.banded_sin_system(1024, 8)
    c, cj = _csr_pair(s.A)
    for norm in ("linf", "rel_l2"):
        got = _cg_pair(c, cj, s.b, s.x0, tol=1e-6, norm=norm)
        ref = oracle.cg(s.A, s.b, s.x0, tol=1e-6, norm=norm)
        assert got.converged and got.iterations == ref.iterations


def _cg_exact_x0_min_iter_no_nan():
    s = tgen.tridiagonal_system(256)
    x_exact = oracle.direct_solve(s.A, s.b)
    c, cj = _csr_pair(s.A)
    res = _cg_pair(c, cj, s.b, x_exact, tol=1e-10, norm="rel_l2", min_iteration=5)
    assert np.all(np.isfinite(res.x))
    r = s.b - oracle.spmv(s.A, res.x)
    assert np.linalg.norm(r) / np.linalg.norm(s.b) < 1e-10


def _aggregate_matches_python():
    S = sp.random(400, 400, density=0.02, random_state=0, format="csr")
    S = (S + S.T + sp.eye(400)).tocsr()
    ip, ix, ad = S.indptr, S.indices, np.abs(S.data)
    agg, n_agg = native.aggregate(ip, ix, ad)
    jagg, jn = jnative.aggregate(ip, ix, ad)
    pagg, pn = amg._aggregate_python(ip, ix, ad)
    assert n_agg == jn == pn and agg.dtype == np.int64
    np.testing.assert_array_equal(agg, jagg)
    np.testing.assert_array_equal(agg, pagg)
    np.testing.assert_array_equal(amg._aggregate(S)[0], agg)


#: the ten cases of tests/test_native.py
CASES = {
    "coo_to_csr": _coo_to_csr,
    "spmv": _spmv,
    "halo_ranges": _halo_ranges,
    "csr_to_dia_and_ell": _csr_to_dia_and_ell,
    "banded_sin_generator": _banded_sin_generator,
    "cg_matches_oracle": _cg_matches_oracle,
    "cg_nonconvergence_policy": _cg_nonconvergence_policy,
    "cg_linf_and_rel_norms": _cg_linf_and_rel_norms,
    "cg_exact_x0_min_iter_no_nan": _cg_exact_x0_min_iter_no_nan,
    "aggregate_matches_python": _aggregate_matches_python,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_kit_equals_the_jax_kit_and_numpy(case):
    CASES[case]()


@pytest.mark.parametrize("norm", ["l2", "rel_l2", "linf"])
def test_native_facade_equals_the_jax_facade(norm):
    """``api.solve(method="native")`` on a DIA system (made CSR by the
    facade) and on a tensor b: the JAX facade's count, flag and x, host
    numpy out; a block raises the JAX facade's ``ValueError``."""
    s, sj = tgen.poisson_system((15, 17)), jgen.poisson_system((15, 17))
    kw = dict(method="native", tol=1e-9, norm=norm)
    r = api.solve(s.A, torch.from_numpy(s.b), **kw)
    jr = japi.solve(sj.A, sj.b, **kw)
    assert isinstance(r.x, np.ndarray) and r.x.dtype == np.float64
    assert r.converged == bool(jr.converged) and r.iterations == int(jr.iterations)
    assert np.abs(r.x - np.asarray(jr.x)).max() <= CG_REL * np.abs(np.asarray(jr.x)).max()
    capped = api.solve(s.A, s.b, max_iteration=3, **kw)
    assert not capped.converged and capped.iterations == 3
    with pytest.raises(ValueError, match="does not support"):
        api.solve(s.A, np.stack([s.b, s.b], 1), **kw)


def test_no_host_compiler_runs_the_numpy_paths(monkeypatch):
    """With no compiler the kit is unavailable and each function runs its
    numpy counterpart (``aggregate``: ``None``, so the AMG setup runs the
    Python loop).  A named compiler that fails still raises."""
    s = tgen.banded_sin_system(256, 8)
    c = formats.dia_to_csr(s.A)
    S = sp.csr_matrix(formats.csr_to_dense(c).data)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setenv("PATH", "")
    _build.load_host.cache_clear()
    try:
        assert not native.available() and native.threads() == 0
        assert native.aggregate(S.indptr, S.indices, np.abs(S.data)) is None
        np.testing.assert_array_equal(amg._aggregate(S)[0], amg._aggregate(S, impl="python")[0])
        got, ref = native.cg(c, s.b, tol=1e-8), oracle.cg(c, s.b, tol=1e-8)
        np.testing.assert_array_equal(got.x, ref.x)
        assert got.history == ref.history and got.iterations == ref.iterations
        np.testing.assert_array_equal(native.csr_to_dia(c).data, formats.csr_to_dia(c).data)
        monkeypatch.setenv("CXX", "/nonexistent/c++")
        with pytest.raises(RuntimeError, match="host compiler"):
            native.available()
    finally:
        _build.load_host.cache_clear()


def test_a_compiler_without_openmp_builds_the_kit_serially(monkeypatch, tmp_path):
    """A compiler that refuses ``-fopenmp`` builds the kit without it (as
    the JAX loader retries): the kit is available, runs serially
    (``threads() == 0``), gives the same conversions and CG, and keeps the
    refusal beside the library."""
    fake = tmp_path / "no-openmp-c++"
    fake.write_text('#!/bin/sh\nfor a in "$@"; do [ "$a" = -fopenmp ] && '
                    '{ echo "openmp not supported" >&2; exit 1; }; done\nexec g++ "$@"\n')
    fake.chmod(0o755)
    s = tgen.banded_sin_system(512, 8)
    c = formats.dia_to_csr(s.A)
    want = native.cg(c, s.b, tol=1e-10)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    _build.load_host.cache_clear()
    try:
        assert native.available() and native.threads() == 0
        log = _build.host_library_path("csrkit").with_suffix(".log")
        assert "openmp not supported" in log.read_text()
        got = native.cg(c, s.b, tol=1e-10)
        assert got.iterations == want.iterations
        assert np.abs(got.x - want.x).max() <= CG_REL * np.abs(want.x).max()
        np.testing.assert_array_equal(native.csr_to_ell(c).data, formats.csr_to_ell(c).data)
    finally:
        _build.load_host.cache_clear()
