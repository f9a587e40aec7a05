"""The port's distributed AMG (``parallel.shard_amg``) against the JAX
package's, on the CPU.

The port runs on ``make_mesh(k, devices=["cpu"] * k)``, the JAX package's
``shard_map`` on the 8-device CPU mesh of ``tests/conftest.py``; both build
their hierarchies from the same fp64 arrays of the port's numpy generators
(the port's SA setup is the JAX package's bit for bit,
``tests/test_torch_amg.py``).  Each JAX result is built once per module (one
JAX program a configuration):

- the per-shard rectangular blocks (``_rect_shard_arrays``) equal the JAX
  package's bit for bit and reproduce ``S @ v`` on both window conventions;
- ``amg_cg`` (Poisson 31^2, 961 rows padded to 968), ``amg_bicgstab``,
  ``amg_gmres``, ``amg_fgmres`` (eps-0.1 convection 25^2, Jacobi
  smoothing) and ``amg_minres`` (Poisson) on 8 shards take the JAX
  package's sharded count exactly, x within X_REL of its x and SOL_REL of
  the direct solve; ``amg_cg`` also the port's single-device count;
- the W-cycle on a four-level hierarchy, with one sharded level over a
  two-level replicated tail and with two sharded levels over a one-level
  tail, takes the count of the JAX package's sharded W-cycle over two
  sharded levels exactly, x within X_REL, its residual within W_REL.  (The
  JAX package's sharded W-cycle repeats nothing at the tail's top, so
  under one sharded level it runs a V-cycle; the port's repeats there as
  the single-device cycle does);
- the permuted Poisson matrix falls to the all-gather window on every level
  and still converges; a hierarchy passed in is reused; a system too small
  to distribute raises the JAX package's ``ValueError``;
- the facade's ``amg_cg`` and ``amg_bicgstab`` with ``mesh=`` take the JAX
  package's sharded counts.
"""

import functools

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import shard_amg as jsa
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.io import from_scipy, to_scipy
from conjugategradient_tpu_torch.parallel import build_sharded_amg, make_mesh, sharded_amg_solve
from conjugategradient_tpu_torch.parallel import shard_amg as sa
from conjugategradient_tpu_torch.precond.amg import amg_cg_solve, build_amg_hierarchy
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x|
X_REL = 1e-9
#: a converged solve against the direct solve (max-norm, relative)
SOL_REL = 1e-6
#: the W-cycle's recurrence residual against the JAX package's (a V-cycle's
#: differs by 10% on the W-cycle test's hierarchy)
W_REL = 1e-6
POL = dict(tol=1e-8, norm="rel_l2")


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


def _csr(A):
    return to_scipy(A).tocsr()


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def poisson31():
    s = tgen.poisson_system((31, 31))
    return s, _csr(s.A)


@pytest.fixture(scope="module")
def convdiff25():
    s = tgen.convection_diffusion_system((25, 25), eps=0.1)
    return s, _csr(s.A), oracle.direct_solve(s.A, s.b)


def _jcsr(s):
    return jformats.dia_to_csr(jformats.DiaMatrix(s.A.data, s.A.offsets, s.A.shape))


@pytest.fixture(scope="module")
def jax_amg(poisson31, convdiff25):
    """The JAX package's sharded AMG solve on 8 devices by base: cg and
    minres on Poisson 31^2, the rest on the convection."""
    def run(method):
        s = poisson31[0] if method in ("cg", "minres") else convdiff25[0]
        return jsa.sharded_amg_solve(_jcsr(s), s.b, policy=JPolicy(**POL), mesh=j_mesh(8),
                                     method=method)[0]

    return functools.cache(run)


def test_rect_shard_arrays_equal_jax_and_reproduce_the_product():
    rng = np.random.default_rng(0)
    for S, num in ((sp.random(32, 16, density=0.3, random_state=0, format="csr"), 4),
                   (sp.diags([1.0, 2.0, 3.0], [-1, 0, 1], shape=(64, 64), format="csr"), 8)):
        got = sa._rect_shard_arrays(S, num)
        want = jsa._rect_shard_arrays(S, num)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))
        data, cols, rows, hops, use_ag = got
        v = rng.standard_normal(S.shape[1])
        nr_local, nc_local = S.shape[0] // num, S.shape[1] // num
        y = np.zeros(S.shape[0])
        for s in range(num):
            window = v if use_ag else np.concatenate(
                [v[((s + k) % num) * nc_local:((s + k) % num + 1) * nc_local]
                 for k in range(-hops, hops + 1)])
            np.add.at(y, s * nr_local + rows[s], data[s] * window[cols[s]])
        np.testing.assert_allclose(y, S @ v, atol=1e-12)


def test_amg_cg_takes_the_single_device_count(poisson31, jax_amg):
    s, S = poisson31
    pol = ConvergencePolicy(**POL)
    r, h = sharded_amg_solve(from_scipy(S), s.b, policy=pol, mesh=_mesh(8))
    one, _ = amg_cg_solve(from_scipy(S), s.b, policy=pol, hierarchy=h)
    jr = jax_amg("cg")
    assert r.converged and tuple(r.x.shape) == (s.n,)
    assert r.iterations == one.iterations == int(jr.iterations)
    assert _rel(r.x, one.x) <= X_REL and _rel(r.x, jr.x) <= X_REL


@pytest.fixture(scope="module")
def jax_wcycle(poisson31):
    """The JAX package's sharded W-cycle CG on Poisson 31^2 over a
    four-level hierarchy (961, 121, 16 rows and a dense 4 x 4), two levels
    sharded on 8 devices (min_local 8), where its cycle is the
    single-device W-cycle."""
    s = poisson31[0]
    return jsa.sharded_amg_solve(_jcsr(s), s.b, policy=JPolicy(**POL), mesh=j_mesh(8), gamma=2,
                                 min_local=8, max_coarse=4)[0]


def _wcycle(poisson31, jr, min_local, split):
    """gamma = 2 on 8 shards of the four-level hierarchy at ``min_local``
    (``split``: sharded levels, tail levels): the single-device W-cycle,
    the count of the JAX package's sharded W-cycle over two sharded levels
    exactly, x within X_REL, the recurrence residual within W_REL."""
    s, S = poisson31
    pol = ConvergencePolicy(**POL)
    h = build_amg_hierarchy(from_scipy(S), dtype=np.float64, max_coarse=4, device="cpu")
    assert len(h.levels) == 3
    sh = build_sharded_amg(h, _mesh(8), min_local=min_local)
    assert (len(sh.metas), len(sh.tail.levels)) == split
    r, _ = sharded_amg_solve(from_scipy(S), s.b, policy=pol, mesh=_mesh(8), hierarchy=h, gamma=2,
                             min_local=min_local)
    assert r.converged and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL
    assert abs(float(r.residual) / float(jr.residual) - 1.0) <= W_REL


def test_amg_wcycle_with_a_deep_tail(poisson31, jax_wcycle):
    """min_local 32 shards level 0 over a replicated tail of two levels:
    gamma rides into the tail, its top too."""
    _wcycle(poisson31, jax_wcycle, 32, (1, 2))


def test_amg_wcycle_over_two_sharded_levels(poisson31, jax_wcycle):
    """min_local 8 shards levels 0 and 1 over a tail of one."""
    _wcycle(poisson31, jax_wcycle, 8, (2, 1))


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "fgmres", "minres"])
def test_amg_krylov_bases(poisson31, convdiff25, jax_amg, method):
    """The nonsymmetric bases on eps-0.1 convection (Jacobi smoothing),
    MINRES on Poisson, 8 shards: the JAX package's sharded count exactly, x
    within X_REL of its x and SOL_REL of the direct solve."""
    if method == "minres":
        s, S = poisson31
        x_true = oracle.direct_solve(s.A, s.b)
    else:
        s, S, x_true = convdiff25
    r, _ = sharded_amg_solve(from_scipy(S), s.b, policy=ConvergencePolicy(**POL), mesh=_mesh(8),
                             method=method)
    jr = jax_amg(method)
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL and _rel(r.x, x_true) <= SOL_REL


def test_permuted_matrix_takes_the_allgather_window():
    """A randomly permuted Poisson matrix destroys aggregate locality: every
    sharded product gathers the whole vector; the solve still converges."""
    s = tgen.poisson_system((25, 25))
    S = _csr(s.A)
    perm = np.random.default_rng(1).permutation(S.shape[0])
    Pm = sp.csr_matrix((np.ones(len(perm)), (np.arange(len(perm)), perm)), shape=S.shape)
    Sp = (Pm @ S @ Pm.T).tocsr()
    bp = np.asarray(s.b)[perm]
    h = build_amg_hierarchy(from_scipy(Sp), dtype=np.float64, device="cpu")
    sh = build_sharded_amg(h, _mesh(8))
    assert sh.metas and all(m.ag_A for m in sh.metas)
    r, _ = sharded_amg_solve(from_scipy(Sp), bp, policy=ConvergencePolicy(**POL), mesh=_mesh(8),
                             hierarchy=h)
    assert r.converged and _rel(r.x, sp.linalg.spsolve(Sp.tocsc(), bp)) <= SOL_REL


def test_hierarchy_reuse_stencil_levels_and_tiny_refusal():
    """A hierarchy passed in comes back as it is; a DIA input whose levels
    are constant stencils turns each level to host CSR at setup and takes
    the single-device count; n <= max_coarse raises."""
    s = tgen.poisson_system((25, 25))
    pol = ConvergencePolicy(**POL)
    h = build_amg_hierarchy(s.A, dtype=np.float64, device="cpu")
    r, h2 = sharded_amg_solve(s.A, s.b, policy=pol, mesh=_mesh(4), hierarchy=h)
    one, _ = amg_cg_solve(s.A, s.b, policy=pol, hierarchy=h)
    assert h2 is h and r.converged and r.iterations == one.iterations
    tiny = tgen.poisson_system((8, 8))
    with pytest.raises(ValueError, match="too small"):
        sharded_amg_solve(from_scipy(_csr(tiny.A)), tiny.b, policy=pol, mesh=_mesh(4))
    with pytest.raises(ValueError, match="unknown method"):
        sharded_amg_solve(s.A, s.b, policy=pol, mesh=_mesh(4), hierarchy=h, method="idr")


@pytest.mark.parametrize("base", ["cg", "bicgstab"])
def test_facade_amg_mesh_routes(poisson31, convdiff25, jax_amg, base):
    """``api.solve(method="amg_" + base, mesh=)`` on 8 shards: the JAX
    package's sharded count exactly, x within X_REL of its x."""
    s, S = poisson31 if base == "cg" else convdiff25[:2]
    r = api.solve(from_scipy(S), s.b, method=f"amg_{base}", mesh=_mesh(8), dtype=np.float64,
                  **POL)
    jr = jax_amg(base)
    assert r.converged and r.iterations == int(jr.iterations) and _rel(r.x, jr.x) <= X_REL
    assert _rel(r.x, oracle.direct_solve(s.A, s.b)) <= SOL_REL
