"""The port's explicit-collective MGCG (``parallel.shard_mgcg``) against the
JAX package's, on the CPU.

The JAX side runs under ``shard_map`` on the 8-device CPU mesh that
``tests/conftest.py`` gives it; the port on ``make_mesh(k, devices=["cpu"]
* k)``, k shards of one device, kernel #3's twin for every local product.
Both get the same arrays from the port's numpy generators, and build their
hierarchies from them (bit-identical, ``tests/test_torch_mg_kinds.py``).
In fp64:

- the sharded stencil product equals the port's unsharded twin bit for bit
  (the same legs summed in the same order) and the JAX function within
  JAX_REL (XLA sums the legs in its own rounding);
- ``shard_mgcg_solve`` takes the JAX package's iteration counts on 1, 2 and
  4 shards, by every variant and on the hybrid, aggregation, plain
  aggregation, 3-D, rbgs and Jacobi hierarchies, a replicated tail
  included, with x within X_REL of the JAX x;
- the split (``n_sharded``) is the JAX package's, and a grid that does not
  shard raises its ``ValueError``;
- poisoned halo buffers and extended slabs (NaN before the first exchange)
  change nothing: the exchange fills every halo row before a product reads
  it, and the legs' halo rows meet only the discarded rows of the result.
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
from conjugategradient_tpu.parallel import shard_mgcg as jsm
from conjugategradient_tpu.precond import build_hierarchy as j_build
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import StencilMatrix, dia_to_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_stencil_ref
from conjugategradient_tpu_torch.parallel import make_mesh, shard_mgcg_solve
from conjugategradient_tpu_torch.parallel import shard_mgcg as sm
from conjugategradient_tpu_torch.parallel.halo import HaloStencil, spmv_stencil_shard
from conjugategradient_tpu_torch.parallel.mesh import shard_rows
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x|
X_REL = 1e-10
#: a sharded product against the JAX one: the same legs in XLA's rounding
JAX_REL = 1e-13
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)
GRID = (64, 32)


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
    """The JAX package's system over the port's arrays."""
    return jgen.LinearSystem(A=jformats.DiaMatrix(s.A.data, s.A.offsets, s.A.shape), b=s.b,
                             x0=s.x0)


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


def _true_rel(s, x):
    r = s.b - oracle.spmv(s.A, np.asarray(x, np.float64))
    return np.linalg.norm(r) / np.linalg.norm(s.b)


# ---------------------------------------------------------------------------
# the sharded stencil product
# ---------------------------------------------------------------------------


def _wide_stencil(grid, rng):
    """A random halo-2 stencil (every shift of the 5 x 5 box), legs zero
    where the neighbour leaves the grid: the wide kernel #3's shape."""
    shifts = tuple((a, b) for a in range(-2, 3) for b in range(-2, 3))
    legs = rng.standard_normal((len(shifts),) + grid)
    idx = np.indices(grid)
    for k, sh in enumerate(shifts):
        inside = np.ones(grid, bool)
        for ax, d in enumerate(sh):
            inside &= (idx[ax] + d >= 0) & (idx[ax] + d < grid[ax])
        legs[k][~inside] = 0.0
    return StencilMatrix(legs, shifts, grid)


@pytest.mark.parametrize("num", [2, 4, 8])
def test_sharded_stencil_product_equals_global(num):
    """The 5-point Poisson legs (halo 1) and a halo-2 box: the sharded
    product equals the global twin bit for bit, the wraparound at the
    global edges included (x = 7.3 everywhere shows any leak), and the
    JAX package's ``spmv_stencil_shard`` on 8 shards within JAX_REL."""
    rng = np.random.default_rng(0)
    st = dia_to_stencil(tgen.poisson_system(GRID).A, GRID)
    wide = _wide_stencil((32, 8), rng)
    m = _mesh(num)
    for A, x in ((st, rng.standard_normal(GRID)), (st, np.full(GRID, 7.3)),
                 (wide, rng.standard_normal((32, 8)))):
        halo0 = max(abs(s[0]) for s in A.shifts)
        got = spmv_stencil_shard(shard_rows(m, A.data, dim=1), A.shifts, shard_rows(m, x, dim=0),
                                 halo0).gather().numpy()
        want = spmv_stencil_ref(A.device_put(None, "cpu"), torch.from_numpy(x)).numpy()
        assert np.array_equal(got, want)
        if num == 8 and A is st:
            fn = jax.shard_map(lambda d, v: jsm.spmv_stencil_shard(d, A.shifts, v, halo0, "x", 8),
                               mesh=j_mesh(8), in_specs=(P(None, "x"), P("x")), out_specs=P("x"))
            jy = np.asarray(jax.jit(fn)(jnp.asarray(A.data), jnp.asarray(x)))
            assert np.abs(got - jy).max() <= JAX_REL * np.abs(jy).max()


def test_halo_stencil_keeps_a_fresh_operand_in_place():
    """A vector written into ``fresh()`` is the product's operand where it
    lies (no copy), and a sibling's buffers are its own."""
    st = dia_to_stencil(tgen.poisson_system(GRID).A, GRID)
    m = _mesh(4)
    op = HaloStencil(shard_rows(m, st.data, dim=1), st.shifts, 1)
    x = shard_rows(m, np.random.default_rng(1).standard_normal(GRID), dim=0)
    want = op(x).gather()
    f = op.fresh(x)
    for dst, src in zip(f.parts, x.parts):
        dst.copy_(src)
    assert torch.equal(op(f).gather(), want)
    assert op.sibling().mats is op.mats
    assert op.sibling()._bufs is None


# ---------------------------------------------------------------------------
# shard_mgcg_solve against the JAX package
# ---------------------------------------------------------------------------

#: label -> (grid, build_hierarchy options): one sharded level above the
#: dense coarse solve, but for "two levels" (both sharded on 4 shards) and
#: "tail" (40 x 32: its 20 x 16 level does not split evenly over 4 shards,
#: so it runs replicated)
CASES = {
    "hyb": (GRID, {}),
    "two levels": (GRID, dict(max_coarse=128)),
    "agg": (GRID, dict(transfer_kind="agg")),
    "plain agg": (GRID, dict(transfer_kind="agg", sa_smooth_levels=0)),
    "3-D": ((16, 8, 8), dict(max_coarse=512)),
    "rbgs": (GRID, dict(smoother="rbgs")),
    "jacobi": (GRID, dict(smoother="jacobi")),
    "tail": ((40, 32), dict(max_coarse=100)),
}


def _solve_both(label, num, variant="cg"):
    grid, opts = CASES[label]
    s = tgen.poisson_system(grid)
    h = build_hierarchy(s.A, grid, device="cpu", **opts)
    jh = j_build(_jsys(s).A, grid, layout="stencil", **opts)
    r = shard_mgcg_solve(s, grid, mesh=_mesh(num), policy=ConvergencePolicy(**POL), hierarchy=h,
                         variant=variant)
    jr = jsm.shard_mgcg_solve(_jsys(s), grid, mesh=j_mesh(num), policy=JPolicy(**POL),
                              hierarchy=jh, variant=variant)
    return s, h, jh, r, jr


def _check(s, r, jr):
    assert r.converged and bool(jr.converged)
    assert r.iterations == int(jr.iterations)
    assert _rel(r.x.numpy(), jr.x) <= X_REL
    assert _true_rel(s, r.x.numpy()) < 1e-9


@pytest.mark.parametrize("num", [1, 2, 4])
def test_shard_mgcg_counts_match_jax(num):
    s, _, _, r, jr = _solve_both("hyb", num)
    _check(s, r, jr)


@pytest.mark.parametrize("variant", ["cg1", "pipelined"])
def test_shard_mgcg_variants_match_jax(variant):
    s, _, _, r, jr = _solve_both("hyb", 4, variant)
    _check(s, r, jr)


@pytest.mark.parametrize("label", ["two levels", "agg", "plain agg", "3-D", "rbgs", "jacobi",
                                   "tail"])
def test_shard_mgcg_hierarchies_match_jax(label):
    """Each hierarchy's split is the JAX package's (the tail case keeps
    levels replicated), and the 4-shard solve takes its count."""
    s, h, jh, r, jr = _solve_both(label, 4)
    n_port = sm._prep_shard_hierarchy(s.A, CASES[label][0], _mesh(4), "x", "chebyshev", 2, 2,
                                      np.float64, h)[1]
    n_jax = 0
    for lvl in jh.levels:
        if not jsm._shardable(lvl, 4):
            break
        n_jax += 1
    assert n_port == n_jax >= 1
    assert (n_port < len(h.levels)) == (label == "tail")
    _check(s, r, jr)


def test_shard_mgcg_refuses_what_the_jax_package_refuses():
    s = tgen.poisson_system((63, 31))
    with pytest.raises(ValueError, match="does not shard"):
        shard_mgcg_solve(s, (63, 31), mesh=_mesh(4))
    with pytest.raises(ValueError, match="does not shard"):
        jsm.shard_mgcg_solve(_jsys(s), (63, 31), mesh=j_mesh(4))
    small = tgen.poisson_system((16, 8))
    with pytest.raises(ValueError, match=">= 1 level"):
        shard_mgcg_solve(small, (16, 8), mesh=_mesh(2))
    with pytest.raises(ValueError, match="variant"):
        shard_mgcg_solve(tgen.poisson_system(GRID), GRID, mesh=_mesh(2), variant="cacg")


def test_poisoned_buffers_change_nothing():
    """NaN in every persistent halo buffer and in the halo rows of every
    extended slab before the first exchange: the solve stays finite and
    equal, bit for bit, to the clean one."""
    grid, opts = CASES["hyb"]
    s = tgen.poisson_system(grid)
    h = build_hierarchy(s.A, grid, device="cpu", **opts)
    pol = ConvergencePolicy(**POL)
    m = _mesh(4)
    clean_solve, (b, x0) = sm.make_shard_mgcg(s, grid, m, pol, hierarchy=h)
    clean = clean_solve(b, x0)
    solve, (b, x0) = sm.make_shard_mgcg(s, grid, m, pol, hierarchy=h)
    for op in solve.operators:
        H, n0 = op.halo, op.local[0]
        like = shard_rows(m, np.zeros((n0 * m.size,) + op.local[1:]), dim=0)
        for buf in op._buffers(like):
            for t in buf.parts:
                t.fill_(float("nan"))
        for A in op.mats.parts:
            A.data[:, :H].fill_(float("nan"))
            A.data[:, H + n0:].fill_(float("nan"))
    got = solve(b, x0)
    assert bool(torch.isfinite(got.x).all())
    assert got.iterations == clean.iterations
    assert torch.equal(got.x, clean.x)
