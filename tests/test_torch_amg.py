"""Smoothed-aggregation AMG of the port against the JAX package's, on the
CPU.

The setup is the JAX package's host numpy and scipy, so every host array of
the hierarchy is bit-identical: aggregates, weights, bounds, P, R, each
level operator's type and data, and the coarse inverse, in five cases that
take the five transfer forms (N-D cubes, greedy aggregates over CSR levels,
1-D strips over DIA levels, variable-coefficient stencil levels, and the
unsmoothed prolongator of a nonsymmetric operator).  A JAX hierarchy
carried across by ``convert.amg_hierarchy_from_reference`` computes the JAX
cycle, V and W; ``amg_cg`` takes the JAX package's iteration counts in
fp64.  The greedy aggregation's C++ build, its Python loop and the JAX
package's agree bit for bit.  Inputs are made from numpy seeds and handed
to both packages."""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.io import from_scipy as j_from_scipy
from conjugategradient_tpu.precond import amg as jamg
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import amg_hierarchy_from_reference
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.io import from_scipy, to_scipy
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.precond import amg as tamg
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: one cycle of the same hierarchy in fp64: only summation orders differ
CYCLE_REL = 1e-12
#: the same CG recurrence in fp64
X_ABS = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _permuted(S, seed=3):
    perm = np.random.default_rng(seed).permutation(S.shape[0])
    return S[perm][:, perm].tocsr()


def _poisson(grid):
    return to_scipy(tgen.poisson_system(grid).A)


#: (port input, JAX input, build keywords, the transfer form of every level)
def _case(name):
    if name == "poisson 33^2 (cubes)":
        S = _poisson((33, 33))
        return from_scipy(S), j_from_scipy(S), dict(max_coarse=20), "blk_nd"
    if name == "poisson 33^2 permuted (greedy)":
        S = _permuted(_poisson((33, 33)))
        return S, S, dict(max_coarse=20), "agg"
    if name == "banded_sin 2048 band 16 (strips)":
        return (tgen.banded_sin_matrix(2048, 16), jgen.banded_sin_matrix(2048, 16), {}, "blk")
    if name == "jump 15^3 (stencil levels)":
        S = to_scipy(tgen.diffusion_system((15, 15, 15), kind="jump", contrast=1e3, seed=0).A)
        return S, S, dict(max_coarse=20), "blk_nd"
    # nonsymmetric upwind convection-diffusion, each side from its own
    # package's generator
    St = to_scipy(tgen.convection_diffusion_matrix((31, 31), eps=0.1))
    Sj = sp.csr_matrix(jfmt.dia_to_dense(jgen.convection_diffusion_matrix((31, 31), eps=0.1)).data)
    return St, Sj, dict(max_coarse=20, smoother="jacobi"), "blk_nd"


CASES = ["poisson 33^2 (cubes)", "poisson 33^2 permuted (greedy)",
         "banded_sin 2048 band 16 (strips)", "jump 15^3 (stencil levels)",
         "convection 31^2 eps 0.1 (unsmoothed P)"]


@functools.lru_cache(maxsize=None)
def _built(name):
    At, Aj, kw, form = _case(name)
    return jamg.build_amg_hierarchy(Aj, **kw), tamg.build_amg_hierarchy(At, device="cpu", **kw)


def _same_op(a, b):
    assert type(a).__name__ == type(b).__name__
    for f in ("data", "indices", "indptr", "row_ids"):
        if hasattr(a, f):
            u, v = np.asarray(getattr(a, f)), getattr(b, f).numpy()
            assert u.dtype == v.dtype and np.array_equal(u, v), f
    for f in ("offsets", "shifts", "grid", "coeffs", "shape"):
        if hasattr(a, f):
            assert tuple(getattr(a, f)) == tuple(getattr(b, f)), f


@pytest.mark.parametrize("name", CASES)
def test_hierarchy_bit_identical(name):
    hj, ht = _built(name)
    form = _case(name)[3]
    assert len(ht.levels) == len(hj.levels) >= 2
    for lj, lt in zip(hj.levels, ht.levels):
        _same_op(lj.A, lt.A)
        _same_op(lj.P, lt.P)
        _same_op(lj.R, lt.R)
        for f in ("inv_diag", "agg", "w"):
            u, v = getattr(lj, f), getattr(lt, f)
            assert (u is None) == (v is None), f
            if u is not None:
                u, v = np.asarray(u), v.numpy()
                assert u.dtype == v.dtype and u.shape == v.shape and np.array_equal(u, v), f
        assert lt.cheb_bounds == tuple(lj.cheb_bounds)
        assert (lt.nc, lt.sa_c, lt.blk, lt.blk_nd) == (lj.nc, lj.sa_c, lj.blk, lj.blk_nd)
    lt = ht.levels[0]
    assert {"blk_nd": lt.blk_nd is not None, "blk": lt.blk > 0,
            "agg": lt.agg is not None and not lt.blk and lt.blk_nd is None}[form]
    if name.startswith("convection"):
        assert all(l.sa_c == 0.0 for l in ht.levels)
    kinds = {type(l.A).__name__ for l in ht.levels}
    want = {"permuted": {"CsrMatrix"}, "banded_sin": {"DiaMatrix"}, "jump": {"StencilMatrix"}}
    for key, k in want.items():
        if key in name:
            assert kinds == k, kinds
    u, v = np.asarray(hj.coarse_inv), ht.coarse_inv.numpy()
    assert u.dtype == v.dtype and np.array_equal(u, v)
    assert set(ht.setup_s) >= {"aggregate", "galerkin", "coarse_inv", "upload"}


@pytest.mark.parametrize("gamma", [1, 2], ids=["V", "W"])
@pytest.mark.parametrize("name", CASES)
def test_carried_cycle_matches_jax(name, gamma):
    hj, ht = _built(name)
    n = ht.levels[0].A.n
    b = np.random.default_rng(11).standard_normal(n)
    ref = np.asarray(jamg.amg_vcycle(hj, jnp.asarray(b), gamma=gamma))
    scale = np.abs(ref).max()
    for h in (amg_hierarchy_from_reference(hj, device="cpu"), ht):
        out = tamg.amg_vcycle(h, torch.from_numpy(b), gamma=gamma).numpy()
        assert np.abs(out - ref).max() <= CYCLE_REL * scale
    # a block runs one cycle per column, each the single-RHS cycle
    B = np.stack([b, -2.0 * b], axis=1)
    out = tamg.amg_preconditioner(ht, gamma)(torch.from_numpy(B)).numpy()
    one = tamg.amg_vcycle(ht, torch.from_numpy(b), gamma=gamma).numpy()
    assert np.array_equal(out[:, 0], one)


def _systems(name):
    s = tgen.poisson_system((31, 31))
    S = to_scipy(s.A)
    if name == "permuted":
        perm = np.random.default_rng(3).permutation(S.shape[0])
        return S[perm][:, perm].tocsr(), s.b[perm]
    return S, s.b


@pytest.mark.parametrize("name", ["csr", "permuted"])
def test_amg_cg_iterations_equal_jax(name):
    S, b = _systems(name)
    kw = dict(method="amg_cg", tol=1e-10, norm="rel_l2")
    rj = japi.solve(j_from_scipy(S), b, **kw)
    rt = api.solve(from_scipy(S), b, device="cpu", **kw)
    assert rt.converged and int(rj.iterations) == rt.iterations
    assert np.abs(np.asarray(rj.x) - rt.x.numpy()).max() <= X_ABS
    res, h = tamg.amg_cg_solve(from_scipy(S), b, policy=ConvergencePolicy(tol=1e-10, norm="rel_l2"),
                               device="cpu")
    assert res.iterations == rt.iterations and isinstance(h, tamg.AmgHierarchy)


def test_amg_cg_block_columns_equal_jax():
    S, b = _systems("permuted")
    B = np.stack([b, np.random.default_rng(4).standard_normal(b.shape[0])], axis=1)
    kw = dict(method="amg_cg", tol=1e-10, norm="rel_l2", max_coarse=50)
    rj = japi.solve(j_from_scipy(S), B, **kw)
    rt = api.solve(from_scipy(S), B, device="cpu", **kw)
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert bool(rt.converged.all())
    assert np.abs(np.asarray(rj.x) - rt.x.numpy()).max() <= X_ABS


def _strength(theta):
    """The strength graph of a permuted jump-coefficient operator, whose
    couplings span two decades (theta > 0 drops the weak ones)."""
    A = tgen.diffusion_system((17, 19), kind="jump", contrast=1e2, seed=2).A
    S = _permuted(to_scipy(A), seed=5)
    return jamg._strength_graph(S, theta), tamg._strength_graph(S, theta)


@pytest.mark.parametrize("theta", [0.0, 0.3])
def test_aggregation_cpp_python_and_jax_agree(theta):
    Sj, St = _strength(theta)
    assert (Sj != St).nnz == 0
    want, n_want = jamg._aggregate(Sj)
    for impl in ("native", "python"):
        agg, n_agg = tamg._aggregate(St, impl=impl)
        assert agg.dtype == np.int64 and n_agg == n_want and np.array_equal(agg, want), impl
    assert (want >= 0).all() and want.max() == n_want - 1
    with pytest.raises(ValueError, match="impl"):
        tamg._aggregate(St, impl="fortran")


def test_aggregation_build_failure_raises(monkeypatch):
    """No silent fallback to the Python loop: a compiler that fails to run
    is an error."""
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host compiler"):
            tamg._aggregate(_strength(0.0)[1])
    finally:
        _build.load_host.cache_clear()


def test_stagnation_guard_and_nonpositive_diagonal():
    rng = np.random.default_rng(1)
    d = rng.uniform(1.0, 2.0, 300)
    h = tamg.build_amg_hierarchy(sp.diags(d).tocsr(), max_coarse=200, device="cpu")
    hj = jamg.build_amg_hierarchy(sp.diags(d).tocsr(), max_coarse=200)
    assert len(h.levels) == len(hj.levels) == 0
    b = rng.standard_normal(300)
    np.testing.assert_allclose(tamg.amg_vcycle(h, torch.from_numpy(b)).numpy(), b / d, rtol=1e-10)
    A = sp.csr_matrix(np.array([[1.0, 0.0], [0.0, -1.0]]))
    with pytest.raises(ValueError, match="non-positive diagonal"):
        tamg.build_amg_hierarchy(A, max_coarse=1, device="cpu")


def test_infer_grid_equals_jax():
    for n, offs in ((9 * 12, [1, 12]), (10 * 12, [1, 11, 12, 13]), (127 ** 3, [1, 127, 127 ** 2]),
                    (4096, list(range(1, 9))), (512, [1, 2, 5]), (1000, [])):
        assert tamg._infer_grid(n, offs) == jamg._infer_grid(n, offs)
