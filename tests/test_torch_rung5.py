"""The port's rung-5 path (``parallel.rung5``, ``precond.distributed``)
against the JAX package's, on the CPU.

The JAX side runs on a 4-device mesh of the 8-device CPU platform that
``tests/conftest.py`` gives it, the port on ``make_mesh(k, devices=["cpu"]
* k)``; both pad and split alike.  Each JAX program is built once per module
(``functools.cache``): one probed build and its MGCG solve, one plain CG
solve, one rediscretized build and its BiCGStab solve, each on a grid of a
few hundred rows (``tests/test_torch_distributed.py`` holds the other probed
cases to the port's host build, which compiles nothing).  In fp64:

- the slab generators and the assembled systems are bit-identical;
- the probed hierarchy's level grids, transfers and leg sets are the JAX
  package's, its legs, weights and ``inv_diag`` within 1e-12, its
  ``coarse_inv`` within 1e-10 and its Chebyshev bounds within 1e-10
  relative (the same power iteration from the same start);
- the rediscretized build's levels equal the JAX package's bit for bit;
- ``make_rung5_cg``, ``make_rung5_mgcg`` and ``make_rung5_mg_nonsym`` take
  the JAX package's iteration counts exactly, x within X_REL of its x.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import rung5 as jr5
from conjugategradient_tpu.precond import distributed as jdist
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.parallel import make_mesh, rung5
from conjugategradient_tpu_torch.precond import distributed as dist
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x|
X_REL = 1e-10
LEG_ABS = 1e-12
INV_ABS = 1e-10
BOUNDS_REL = 1e-10
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)
#: padded to (16, 16) on four shards
GRID = (14, 16)
CONV_GRID = (32, 32)
EPS = 0.05


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


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


@functools.cache
def _jax_poisson():
    """The JAX rung-5 system on GRID, its probed hierarchy and its CG and
    MGCG solves."""
    mesh = j_mesh(4)
    A, b, x0, padded, n_real = jr5.make_rung5_system(GRID, mesh, dtype=np.float64)
    h = jdist.build_hierarchy_probed(A, mesh, max_coarse=8)
    pol = JPolicy(**POL)
    mgcg = jr5.make_rung5_mgcg(pol, h)(b, x0)
    cg = jr5.make_rung5_cg(pol)(A, b, x0)
    return (A, b, padded), h, jax.device_get(mgcg), jax.device_get(cg)


@functools.cache
def _jax_convection():
    """The JAX convection system on CONV_GRID, its rediscretized hierarchy
    and its mg BiCGStab solve."""
    mesh = j_mesh(4)
    A, b, x0 = jr5.make_convection_system(CONV_GRID, mesh, eps=EPS, dtype=np.float64)
    slab = jgen.convection_diffusion_level_slab(EPS, dtype=np.float64)
    h = jdist.build_hierarchy_redisc(CONV_GRID, mesh, slab, max_coarse=60, dtype=np.float64)
    res = jr5.make_rung5_mg_nonsym(JPolicy(**POL), h)(b, x0)
    return h, jax.device_get(res)


@functools.cache
def _port_poisson():
    mesh = _mesh(4)
    A, b, x0, padded, n_real = rung5.make_rung5_system(GRID, mesh, dtype=np.float64)
    return mesh, (A, b, x0, padded, n_real), dist.build_hierarchy_probed(A, mesh, max_coarse=8)


# ---------------------------------------------------------------------------
# slabs and assembly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid,lo,hi", [((13, 6), 0, 16), ((13, 6), 12, 16), ((7, 5, 9), 2, 8),
                                        ((29,), 4, 32)])
def test_poisson_slabs_are_the_jax_packages(grid, lo, hi):
    assert rung5.unit_shifts(len(grid)) == jr5.unit_shifts(len(grid))
    for dtype in (np.float32, np.float64):
        np.testing.assert_array_equal(rung5.poisson_stencil_slab(grid, lo, hi, dtype),
                                      jr5.poisson_stencil_slab(grid, lo, hi, dtype))
        np.testing.assert_array_equal(rung5.poisson_rhs_slab(grid, lo, hi, dtype, seed=3),
                                      jr5.poisson_rhs_slab(grid, lo, hi, dtype, seed=3))


@pytest.mark.parametrize("grid", [(16, 12), (8, 6, 10)])
@pytest.mark.parametrize("level", [0, 2])
def test_convection_slabs_are_the_jax_packages(grid, level):
    for scheme in ("upwind", "central"):
        slab = tgen.convection_diffusion_level_slab(0.1, scheme=scheme, dtype=np.float64)
        jslab = jgen.convection_diffusion_level_slab(0.1, scheme=scheme, dtype=np.float64)
        np.testing.assert_array_equal(slab(level, grid, 2, 6), jslab(level, grid, 2, 6))
    np.testing.assert_array_equal(tgen.convection_diffusion_rhs_slab(grid, 1, 5, seed=2),
                                  jgen.convection_diffusion_rhs_slab(grid, 1, 5, seed=2))


@pytest.mark.parametrize("num", [1, 2, 4])
def test_assembled_systems_are_the_jax_packages(num):
    """The slab-by-slab assembly gathers to the JAX package's global legs
    and vectors, padded alike; the padded plane is identity rows with zero
    b and x0."""
    A, b, x0, padded, n_real = rung5.make_rung5_system((13, 6), _mesh(num), dtype=np.float64)
    jA, jb, jx0, jpadded, jn = jr5.make_rung5_system((13, 6), j_mesh(num), dtype=np.float64)
    assert (padded, n_real, A.shifts) == (jpadded, jn, jA.shifts)
    np.testing.assert_array_equal(A.data.gather(1).numpy(), np.asarray(jA.data))
    np.testing.assert_array_equal(b.gather().numpy(), np.asarray(jb))
    assert not x0.gather().numpy().any()
    C, cb, cx0 = rung5.make_convection_system(CONV_GRID, _mesh(num), eps=EPS, dtype=np.float64)
    jC, jcb, _ = jr5.make_convection_system(CONV_GRID, j_mesh(num), eps=EPS, dtype=np.float64)
    np.testing.assert_array_equal(C.data.gather(1).numpy(), np.asarray(jC.data))
    np.testing.assert_array_equal(cb.gather().numpy(), np.asarray(jcb))


def test_convection_system_guards():
    mesh = _mesh(4)
    with pytest.raises(ValueError, match="must divide"):
        rung5.make_convection_system((34, 32), mesh)
    with pytest.raises(ValueError, match="even extents"):
        rung5.make_convection_system((32, 31), mesh)


# ---------------------------------------------------------------------------
# the probed and rediscretized hierarchies
# ---------------------------------------------------------------------------


def test_probed_hierarchy_is_the_jax_packages():
    _, hj, _, _ = _jax_poisson()
    mesh, _, h = _port_poisson()
    levels = list(h.levels) + list(h.tail.levels)
    assert len(levels) == len(hj.levels) and h.levels and h.tail.levels
    for L, Lj in zip(levels, hj.levels):
        sharded = hasattr(L, "op")
        kind = L.kind if sharded else L.transfer
        assert L.grid == Lj.grid and kind == Lj.transfer and Lj.sa_smooth is False
        if sharded:
            H, n0 = L.op.halo, L.op.local[0]
            shifts = L.op.shifts
            legs = torch.cat([m.data[:, H:H + n0] for m in L.op.mats.parts], dim=1).numpy()
            inv = L.inv_diag.gather(0).numpy()
            w = None if L.weight is None else L.weight.gather(0).numpy()
            bounds = L.bounds
        else:
            shifts, legs, inv = L.A.shifts, L.A.data.numpy(), L.inv_diag.numpy()
            w = None if L.weight is None else L.weight.numpy()
            bounds = L.cheb_bounds
        assert tuple(shifts) == tuple(Lj.A.shifts)
        np.testing.assert_allclose(legs, np.asarray(Lj.A.data), rtol=0, atol=LEG_ABS)
        np.testing.assert_allclose(inv, np.asarray(Lj.inv_diag), rtol=0, atol=LEG_ABS)
        assert (w is None) == (Lj.weight is None)
        if w is not None:
            np.testing.assert_allclose(w, np.asarray(Lj.weight), rtol=0, atol=LEG_ABS)
        np.testing.assert_allclose(bounds, Lj.cheb_bounds, rtol=BOUNDS_REL, atol=0)
    np.testing.assert_allclose(h.coarse_inv.numpy(), np.asarray(hj.coarse_inv), rtol=0,
                               atol=INV_ABS)


def test_redisc_levels_are_the_jax_packages_bit_for_bit():
    hj, _ = _jax_convection()
    slab = tgen.convection_diffusion_level_slab(EPS, dtype=np.float64)
    h = dist.build_hierarchy_redisc(CONV_GRID, _mesh(4), slab, max_coarse=60, dtype=np.float64)
    assert len(h.levels) == len(hj.levels) and not h.tail.levels
    for L, Lj in zip(h.levels, hj.levels):
        assert L.grid == Lj.grid and L.kind == Lj.transfer == "hyb"
        H, n0 = L.op.halo, L.op.local[0]
        legs = torch.cat([m.data[:, H:H + n0] for m in L.op.mats.parts], dim=1).numpy()
        np.testing.assert_array_equal(legs, np.asarray(Lj.A.data))
        np.testing.assert_array_equal(L.inv_diag.gather(0).numpy(), np.asarray(Lj.inv_diag))
        np.testing.assert_allclose(L.bounds, Lj.cheb_bounds, rtol=BOUNDS_REL, atol=0)
    np.testing.assert_array_equal(h.coarse_inv.numpy(), np.asarray(hj.coarse_inv))


# ---------------------------------------------------------------------------
# the rung-5 solves
# ---------------------------------------------------------------------------


def test_rung5_cg_takes_the_jax_count():
    (_, _, padded), _, _, jres = _jax_poisson()
    _, (A, b, x0, _, _), _ = _port_poisson()
    res = rung5.make_rung5_cg(ConvergencePolicy(**POL))(A, b, x0)
    assert res.converged and res.iterations == int(jres.iterations)
    x = res.x.gather().numpy()
    assert _rel(x, jres.x) <= X_REL
    assert np.all(x[GRID[0]:] == 0.0)


def test_rung5_mgcg_takes_the_jax_count():
    """The port masks the padded plane of each V-cycle's output (the JAX
    package's cycle carries corrections into it, which converge to 0 with
    the rest): the JAX count, x within X_REL on the real rows, the padded
    rows exactly 0."""
    _, _, jres, _ = _jax_poisson()
    _, (A, b, x0, _, _), h = _port_poisson()
    assert h.real0 == GRID[0]
    res = rung5.make_rung5_mgcg(ConvergencePolicy(**POL), h)(b, x0)
    x = res.x.gather().numpy()
    assert res.converged and res.iterations == int(jres.iterations)
    assert _rel(x[:GRID[0]], np.asarray(jres.x)[:GRID[0]]) <= X_REL
    assert np.all(x[GRID[0]:] == 0.0)


def test_rung5_mg_bicgstab_takes_the_jax_count():
    _, jres = _jax_convection()
    mesh = _mesh(4)
    A, b, x0 = rung5.make_convection_system(CONV_GRID, mesh, eps=EPS, dtype=np.float64)
    slab = tgen.convection_diffusion_level_slab(EPS, dtype=np.float64)
    h = dist.build_hierarchy_redisc(CONV_GRID, mesh, slab, max_coarse=60, dtype=np.float64)
    res = rung5.make_rung5_mg_nonsym(ConvergencePolicy(**POL), h)(b, x0)
    assert res.converged and res.iterations == int(jres.iterations)
    assert _rel(res.x.gather().numpy(), jres.x) <= X_REL
    with pytest.raises(ValueError, match="unknown method"):
        rung5.make_rung5_mg_nonsym(ConvergencePolicy(**POL), h, method="idr")
