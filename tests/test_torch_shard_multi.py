"""The port's sharded multi-RHS solvers (``parallel.shard_multi``) against
the JAX package's, on the CPU.

As in ``tests/test_torch_shard_mgcg.py``: the JAX side under ``shard_map``
on the 8-device CPU mesh, the port on ``make_mesh(k, devices=["cpu"] *
k)``, the same arrays from the port's numpy generators, fp64.

- ``spmm_stencil_shard`` (k columns leading, the port's layout) equals the
  port's unsharded ``spmm_columns`` bit for bit and the JAX function (k
  trailing) within JAX_REL;
- ``shard_multi_mgcg_solve`` takes the JAX package's per-column counts on
  1, 2 and 4 shards with x within X_REL; a zero column freezes at once
  (count 0, x exactly 0) while the others run, and a solve capped at 3
  iterations flags every column not converged;
- ``sharded_cg_multi_solve`` takes the JAX package's per-column counts for
  ``cg`` and ``bicgstab`` in ``rel_l2`` and ``linf`` on 4 shards (kernel
  #5's twin on each shard's extended DIA), and on 8 shards where the band
  passes a shard (the all-gather window);
- the block solvers on one device are unchanged: ``cg_solve_multi`` with
  and without the sharded hooks on one shard agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import shard_multi as jmulti
from conjugategradient_tpu.precond import build_hierarchy as j_build
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import dia_to_stencil
from conjugategradient_tpu_torch.ops.stencil import spmm_columns
from conjugategradient_tpu_torch.parallel import make_mesh, shard_multi_mgcg_solve
from conjugategradient_tpu_torch.parallel.mesh import Shards, shard_rows
from conjugategradient_tpu_torch.parallel.shard_multi import spmm_stencil_shard, sharded_cg_multi_solve
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

X_REL = 1e-10
JAX_REL = 1e-13
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)
GRID = (64, 32)
K = 3


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


def _jsys(s):
    return jgen.LinearSystem(A=jformats.DiaMatrix(s.A.data, s.A.offsets, s.A.shape), b=s.b,
                             x0=s.x0)


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


def _block(n, k, seed):
    return np.random.default_rng(seed).standard_normal((n, k))


def test_spmm_stencil_shard_equals_global():
    st = dia_to_stencil(tgen.poisson_system(GRID).A, GRID)
    X = np.random.default_rng(0).standard_normal((K,) + GRID)  # k columns leading
    m = _mesh(4)
    got = spmm_stencil_shard(shard_rows(m, st.data, dim=1), st.shifts, shard_rows(m, X, dim=1),
                             1).gather(dim=1).numpy()
    want = spmm_columns(st.device_put(None, "cpu"), torch.from_numpy(X)).numpy()
    assert np.array_equal(got, want)
    fn = jax.shard_map(lambda d, v: jmulti.spmm_stencil_shard(d, st.shifts, v, 1, "x", 8),
                       mesh=j_mesh(8), in_specs=(P(None, "x"), P("x")), out_specs=P("x"))
    jy = np.moveaxis(np.asarray(jax.jit(fn)(jnp.asarray(st.data),
                                            jnp.asarray(np.moveaxis(X, 0, -1)))), -1, 0)
    assert np.abs(got - jy).max() <= JAX_REL * np.abs(jy).max()


@pytest.fixture(scope="module")
def mg_case():
    s = tgen.poisson_system(GRID)
    return (s, build_hierarchy(s.A, GRID, device="cpu"),
            j_build(_jsys(s).A, GRID, layout="stencil"))


@pytest.mark.parametrize("num", [1, 2, 4])
def test_shard_multi_mgcg_counts_match_jax(mg_case, num):
    s, h, jh = mg_case
    B = _block(s.n, K, seed=num)
    r = shard_multi_mgcg_solve(s, B, GRID, mesh=_mesh(num), policy=ConvergencePolicy(**POL),
                               hierarchy=h)
    jr = jmulti.shard_multi_mgcg_solve(_jsys(s), B, GRID, mesh=j_mesh(num), policy=JPolicy(**POL),
                                       hierarchy=jh)
    assert bool(r.converged.all()) and bool(np.asarray(jr.converged).all())
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(jr.iterations))
    assert tuple(r.x.shape) == (s.n, K) and _rel(r.x.numpy(), jr.x) <= X_REL
    for j in range(K):
        res = B[:, j] - oracle.spmv(s.A, r.x[:, j].numpy())
        assert np.linalg.norm(res) / np.linalg.norm(B[:, j]) < 1e-9


def test_shard_multi_mgcg_freezes_and_flags_columns(mg_case):
    """A column whose solution is the constant converges no later than a
    random one, and a zero column is converged at once and stays frozen
    (x exactly 0, count 0) while the others run; a solve capped at 3
    iterations flags every column, each at 3."""
    s, h, _ = mg_case
    easy = oracle.spmv(s.A, np.ones(s.n))
    B = np.stack([easy, _block(s.n, 1, seed=5)[:, 0], np.zeros(s.n)], axis=1)
    r = shard_multi_mgcg_solve(s, B, GRID, mesh=_mesh(4), policy=ConvergencePolicy(**POL),
                               hierarchy=h)
    its = r.iterations.numpy()
    assert bool(r.converged.all()) and its[0] <= its[1] and its[2] == 0 < its[1]
    assert np.abs(r.x[:, 0].numpy() - 1.0).max() < 1e-8
    assert not bool(r.x[:, 2].any())
    capped = shard_multi_mgcg_solve(s, B[:, :2], GRID, mesh=_mesh(4), hierarchy=h,
                                    policy=ConvergencePolicy(tol=1e-30, max_iteration=3))
    assert not bool(capped.converged.any())
    np.testing.assert_array_equal(capped.iterations.numpy(), [3, 3])
    with pytest.raises(ValueError, match="B rows"):
        shard_multi_mgcg_solve(s, _block(100, 2, 0), GRID, mesh=_mesh(4), hierarchy=h)


@pytest.mark.parametrize("method", ["cg", "bicgstab"])
@pytest.mark.parametrize("norm", ["rel_l2", "linf"])
def test_sharded_cg_multi_matches_jax(method, norm):
    s = tgen.banded_sin_system(512, 16)
    B = _block(s.n, K, seed=3)
    kw = dict(tol=1e-9, norm=norm, max_iteration=2000)
    r = sharded_cg_multi_solve(s.A, B, policy=ConvergencePolicy(**kw), mesh=_mesh(4),
                               method=method)
    jr = jmulti.sharded_cg_multi_solve(_jsys(s).A, B, policy=JPolicy(**kw), mesh=j_mesh(4),
                                       method=method)
    assert bool(r.converged.all()) and bool(np.asarray(jr.converged).all())
    np.testing.assert_array_equal(r.iterations.numpy(), np.asarray(jr.iterations))
    assert _rel(r.x.numpy(), jr.x) <= X_REL


def test_sharded_cg_multi_allgather_window():
    """Band 40 on 8 shards of 64 rows: the bandwidth (20) fits; band 160 on
    8 shards of 16 rows (n = 128): it passes a shard, and the product takes
    the gathered window.  Both take the single-device block CG's counts."""
    for n, band in ((512, 40), (128, 160)):
        s = tgen.banded_sin_system(n, band)
        B = _block(n, 2, seed=band)
        pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=2000)
        r = sharded_cg_multi_solve(s.A, B, policy=pol, mesh=_mesh(8))
        ref = cg_solve_multi(s.A.device_put(None, "cpu"), torch.from_numpy(B), policy=pol)
        np.testing.assert_array_equal(r.iterations.numpy(), ref.iterations.numpy())
        assert _rel(r.x.numpy(), ref.x.numpy()) <= X_REL


def test_block_hooks_leave_one_device_solves_alone():
    """``cg_solve_multi`` on one shard through the hooks is the one-device
    solve bit for bit (the psum of one partial is the partial)."""
    s = tgen.banded_sin_system(256, 8)
    B = _block(256, 2, seed=9)
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=2000)
    ref = cg_solve_multi(s.A.device_put(None, "cpu"), torch.from_numpy(B), policy=pol)
    r = sharded_cg_multi_solve(s.A, B, policy=pol, mesh=_mesh(1))
    assert torch.equal(r.x, ref.x) and torch.equal(r.iterations, ref.iterations)
    with pytest.raises(ValueError, match="psum_axis"):
        cg_solve_multi(lambda P: P, torch.from_numpy(B), psum_axis="x")
    assert isinstance(shard_rows(_mesh(2), B, dim=0), Shards)
