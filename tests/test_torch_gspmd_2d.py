"""2-D block partitions over a 2-D mesh (``axes=("x", "y")``) against the
JAX package and against the port's 1-D row blocks, on the CPU.

The JAX package shards grid axes 0 and 1 over a ``Mesh(devices.reshape(px,
py), ("x", "y"))`` with XLA's SPMD partitioner; the port carries the same
blocks with explicit collectives on ``Mesh([["cpu"] * py] * px, ("x",
"y"))``: each shard's ``HaloStencil`` exchanges axis 0, then axis 1 over
the axis-0-extended rows (the corners a 9- or 27-point stencil reads),
the cell-centred transfers cross shards on both axes, and every dot is a
``psum`` of all px * py partials.  fp64; on the CPU kernel #3 runs its
twin.

- The 2-D mesh's collectives: sizes, the row-major order, ``psum``/``pmax``
  over all partials, ``ppermute`` inside each row or column, the block
  split and its gather.
- 2-D ``HaloStencil`` products (5-, 9- and 27-point, one column and k)
  equal the unsharded product to the last bit, on (4, 2) and (2, 4).
- Three JAX programs: ``gspmd_mgcg_solve`` on Poisson 64^2 over (4, 2)
  (``tests/test_gspmd.py:69-83``), ``gspmd_mg_nonsym_solve`` by BiCGStab
  over (2, 4) (``tests/test_gspmd_mg_nonsym.py:83-97``, on the even 32^2
  grid, which shards, where the JAX test's odd 31^2 replicates) and
  ``gspmd_refined_solve`` on jump diffusion 64^2 over (4, 2)
  (``tests/test_refine.py:280-297``): counts equal, x within X_REL.
- The probed and rediscretized builds over (2, 2) against the port's 1-D
  builds over 4 shards: the same levels, legs equal to the last bit.
- ``api.solve``'s ``axes=`` routes, and the JAX facade's ``TypeError``
  for a method that takes no ``axes=``.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import gspmd as jgspmd
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import StencilMatrix, dia_to_stencil
from conjugategradient_tpu_torch.ops.stencil import spmv_stencil
from conjugategradient_tpu_torch.parallel import make_mesh
from conjugategradient_tpu_torch.parallel.gspmd import (
    gspmd_mg_nonsym_solve,
    gspmd_mgcg_solve,
    gspmd_refined_solve,
)
from conjugategradient_tpu_torch.parallel.halo import HaloStencil
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    pmax,
    ppermute,
    psum,
    shard_blocks,
)
from conjugategradient_tpu_torch.precond import distributed as dist
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

X_REL = 1e-10
GRID = (64, 64)
POL = dict(tol=1e-8)
#: the mg_* carrier: the even 32^2 convection grid (its levels shard over
#: (2, 4)), the JAX test's eps and policy
MG_GRID, MG_EPS = (32, 32), 0.05
MG_POL = dict(tol=1e-9, norm="rel_l2")
MG_KW = dict(max_coarse=64)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh2(px, py):
    return Mesh([["cpu"] * py] * px, ("x", "y"))


def _jmesh2(px, py):
    return JMesh(np.array(jax.devices()[:px * py]).reshape(px, py), ("x", "y"))


def _mesh(k):
    return make_mesh(k, devices=["cpu"] * k)


def _jA(A):
    return jformats.DiaMatrix(A.data, A.offsets, A.shape)


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


# ---------------------------------------------------------------------------
# the 2-D mesh and its collectives
# ---------------------------------------------------------------------------


def test_mesh_2d_collectives():
    m = _mesh2(4, 2)
    assert m.shape == {"x": 4, "y": 2} and m.size == 8 and m.dims == (4, 2) and m.ndim == 2
    assert m.axes == ("x", "y") and len(m.devices) == 8
    assert [m.coords(i) for i in range(8)] == [(i // 2, i % 2) for i in range(8)]
    assert all(m.index(m.coords(i)) == i for i in range(8))
    one = make_mesh(4, devices=["cpu"] * 4)
    assert one.axis == "x" and one.shape == {"x": 4} and one.dims == (4,) and one.ndim == 1
    x = Shards([torch.tensor([float(i), -float(i)]) for i in range(8)], m)
    total = psum(x)
    assert all(torch.equal(p, torch.tensor([28.0, -28.0])) for p in total.parts)
    assert all(torch.equal(p, torch.tensor([7.0, 0.0])) for p in pmax(x).parts)
    # axis 0 shifts inside each column, axis 1 inside each row, None the flat ring
    vals = lambda y: [int(p[0]) for p in y.parts]
    assert vals(ppermute(x, 1, "x")) == [6, 7, 0, 1, 2, 3, 4, 5]
    assert vals(ppermute(x, 1, "y")) == [1, 0, 3, 2, 5, 4, 7, 6]
    assert vals(ppermute(x, -1, 0)) == [2, 3, 4, 5, 6, 7, 0, 1]
    assert vals(ppermute(x, 1)) == [7, 0, 1, 2, 3, 4, 5, 6]
    g = torch.arange(8 * 6 * 3, dtype=torch.float64).reshape(8, 6, 3)
    blocks = shard_blocks(m, g, (0, 1))
    assert tuple(blocks.shape) == (2, 3, 3)
    assert torch.equal(blocks.parts[3], g[2:4, 3:6])
    assert torch.equal(blocks.gather((0, 1)), g) and torch.equal(blocks.gather_grid(3), g)
    assert torch.equal(shard_blocks(one, g, (0, 1)).gather_grid(3), g)
    with pytest.raises(ValueError, match="rows of devices"):
        Mesh([["cpu"] * 2, ["cpu"]], ("x", "y"))
    with pytest.raises(ValueError, match="divisible"):
        shard_blocks(m, torch.zeros(6, 6), (0, 1))
    with pytest.raises(ValueError, match="own axes"):
        m.check_axes(("x",))


def _stencil_case(case):
    """(legs, shifts, grid): a 5-point 2-D Poisson, a random 9-point 2-D
    stencil and a random 27-point 3-D one, structurally zero wherever the
    neighbour leaves the grid."""
    if case == "5-point":
        st = dia_to_stencil(tgen.poisson_system(GRID).A, GRID)
        return torch.from_numpy(st.data), st.shifts, GRID
    grid = GRID if case == "9-point" else (16, 8, 6)
    shifts = tuple(np.ndindex(*(3,) * len(grid)))
    shifts = tuple(tuple(s - 1 for s in sh) for sh in shifts)
    legs = np.random.default_rng(7).standard_normal((len(shifts),) + grid)
    for k, sh in enumerate(shifts):
        for ax, s in enumerate(sh):
            if s:
                idx = [slice(None)] * len(grid)
                idx[ax] = 0 if s < 0 else -1
                legs[k][tuple(idx)] = 0.0
    return torch.from_numpy(legs), shifts, grid


@pytest.mark.parametrize("dims", [(4, 2), (2, 4)])
@pytest.mark.parametrize("case", ["5-point", "9-point", "27-point"])
def test_halo_stencil_2d_equals_the_unsharded_product(case, dims):
    """The 2-D blocks' products, one column and k = 3, equal the global
    product to the last bit: the corners arrive through the axis-1
    exchange over the axis-0-extended rows, the wrapped halos meet zero
    legs.  ``halo_bytes`` counts both axes' faces."""
    legs, shifts, grid = _stencil_case(case)
    m = _mesh2(*dims)
    op = HaloStencil(shard_blocks(m, legs, (1, 2)), shifts, (1, 1))
    A = StencilMatrix(legs, shifts, grid)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(grid))
    assert torch.equal(op(shard_blocks(m, x, (0, 1))).gather_grid(len(grid)), spmv_stencil(A, x))
    X = torch.from_numpy(np.random.default_rng(9).standard_normal((3,) + grid))
    want = torch.stack([spmv_stencil(A, c) for c in X])
    assert torch.equal(op(shard_blocks(m, X, (1, 2))).gather_grid(len(grid)), want)
    n0, n1 = grid[0] // dims[0], grid[1] // dims[1]
    rest = int(np.prod(grid[2:]))
    assert op.halo_bytes == m.size * (2 * n1 * rest + 2 * (n0 + 2) * rest) * 8


# ---------------------------------------------------------------------------
# the GSPMD carriers on 2-D blocks against the JAX package
# ---------------------------------------------------------------------------


def test_gspmd_mgcg_2d_matches_jax():
    s = tgen.poisson_system(GRID)
    r = gspmd_mgcg_solve(s, GRID, mesh=_mesh2(4, 2), policy=ConvergencePolicy(**POL),
                         axes=("x", "y"))
    jr = jgspmd.gspmd_mgcg_solve(jgen.LinearSystem(A=_jA(s.A), b=s.b, x0=s.x0), GRID,
                                 mesh=_jmesh2(4, 2), policy=JPolicy(**POL), axes=("x", "y"))
    assert r.converged and bool(jr.converged)
    assert r.iterations == int(jr.iterations) and _rel(r.x.numpy(), jr.x) <= X_REL


@functools.cache
def _mg_case():
    cb = tgen.convection_diffusion_coarse_operator(eps=MG_EPS)
    return tgen.convection_diffusion_system(MG_GRID, eps=MG_EPS), cb


def test_gspmd_mg_bicgstab_2d_matches_jax():
    """Through the facade: ``api.solve(method="mg_bicgstab", mesh=,
    axes=("x", "y"))`` routes to ``gspmd_mg_nonsym_solve`` as the JAX
    facade does."""
    s, cb = _mg_case()
    r = api.solve(s.A, s.b, method="mg_bicgstab", grid=MG_GRID, mesh=_mesh2(2, 4),
                  axes=("x", "y"), coarse_operator=cb, dtype=np.float64, **MG_POL, **MG_KW)
    jr = jgspmd.gspmd_mg_nonsym_solve(
        _jA(s.A), s.b, MG_GRID, mesh=_jmesh2(2, 4), policy=JPolicy(**MG_POL), method="bicgstab",
        axes=("x", "y"), coarse_operator=jgen.convection_diffusion_coarse_operator(eps=MG_EPS),
        **MG_KW)
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x.numpy(), jr.x) <= X_REL
    assert _rel(r.x.numpy(), oracle.direct_solve(s.A, s.b)) <= 1e-7


def test_gspmd_refined_2d_jump_matches_jax():
    s = tgen.diffusion_system(GRID, kind="jump")
    r = gspmd_refined_solve(s.A, s.b, GRID, mesh=_mesh2(4, 2), axes=("x", "y"), tol=1e-10)
    jr = jgspmd.gspmd_refined_solve(_jA(s.A), s.b, GRID, mesh=_jmesh2(4, 2), axes=("x", "y"),
                                    tol=1e-10)
    assert r.converged and jr.converged
    assert np.linalg.norm(s.b - oracle.spmv(s.A, r.x)) < 1e-10
    assert abs(r.outer_iterations - jr.outer_iterations) <= 1
    assert _rel(r.x, jr.x) <= X_REL


@pytest.mark.parametrize("method", ["gmres", "idr"])
def test_gspmd_mg_nonsym_2d_takes_the_1d_count(method):
    """GMRES(20) and IDR(4) (the one global shadow, split into 2-D blocks)
    on the 2-D blocks take the 1-D row blocks' counts: the same iterates
    up to the order of the psum'd partials."""
    s, cb = _mg_case()
    kw = dict(policy=ConvergencePolicy(**MG_POL), method=method, coarse_operator=cb, restart=20,
              **MG_KW)
    r2 = gspmd_mg_nonsym_solve(s.A, s.b, MG_GRID, mesh=_mesh2(2, 4), axes=("x", "y"), **kw)
    r1 = gspmd_mg_nonsym_solve(s.A, s.b, MG_GRID, mesh=_mesh(8), **kw)
    assert r2.converged and r1.converged and r2.iterations == r1.iterations
    assert _rel(r2.x.numpy(), r1.x.numpy()) <= X_REL


# ---------------------------------------------------------------------------
# the distributed setup on 2-D blocks
# ---------------------------------------------------------------------------


def _global_legs(op) -> torch.Tensor:
    blocks = Shards([op._narrowed(m.data, range(len(op.halos))) for m in op.mats.parts], op.mesh)
    return blocks.gather_grid(len(op.local))


def _same_hierarchy(h1, h2):
    assert [(L.grid, L.kind, L.op.shifts) for L in h1.levels] == \
        [(L.grid, L.kind, L.op.shifts) for L in h2.levels]
    assert len(h1.levels) >= 1
    for L1, L2 in zip(h1.levels, h2.levels):
        assert torch.equal(_global_legs(L1.op), _global_legs(L2.op))
        if L1.weight is not None:
            assert torch.equal(L1.weight.gather_grid(len(L1.grid)),
                               L2.weight.gather_grid(len(L2.grid)))
    assert [L.grid for L in h1.tail.levels] == [L.grid for L in h2.tail.levels]
    for L1, L2 in zip(h1.tail.levels, h2.tail.levels):
        assert torch.equal(L1.A.data, L2.A.data)
    assert torch.equal(h1.coarse_inv, h2.coarse_inv)


@pytest.mark.parametrize("grid, kind", [((64, 64), "auto"), ((32, 16, 8), "auto"),
                                        ((24, 24, 8), "agg")])
def test_probed_build_2d_equals_1d(grid, kind):
    """``build_hierarchy_probed(axes=("x", "y"))`` over (2, 2): each probe
    offset by the block's origin on both axes, so the legs (hybrid
    cell-centred probes of period 5, aggregation ones of period 3, a
    24-row grid whose local extent is off the probing period) and the
    dense coarse inverse equal the 1-D build's; MGCG on each takes the
    same count."""
    s = tgen.poisson_system(grid)
    A = dia_to_stencil(s.A, grid)
    h1 = dist.build_hierarchy_probed(A, _mesh(4), transfer_kind=kind)
    h2 = dist.build_hierarchy_probed(A, _mesh2(2, 2), axes=("x", "y"), transfer_kind=kind)
    _same_hierarchy(h1, h2)
    from conjugategradient_tpu_torch.parallel.shard_mgcg import make_shard_mgcg

    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=300)
    out = [make_shard_mgcg(s, grid, m, pol, hierarchy=h) for m, h in
           ((_mesh(4), h1), (_mesh2(2, 2), h2))]
    (a, b) = (solve(*inputs) for solve, inputs in out)
    assert a.converged and b.converged and a.iterations == b.iterations
    assert _rel(b.x.numpy(), a.x.numpy()) <= X_REL


def test_redisc_build_2d_equals_1d():
    slab = tgen.convection_diffusion_level_slab(MG_EPS, dtype=np.float64)
    kw = dict(dtype=np.float64, max_coarse=64)
    h1 = dist.build_hierarchy_redisc(MG_GRID, _mesh(4), slab, **kw)
    h2 = dist.build_hierarchy_redisc(MG_GRID, _mesh2(2, 2), slab, axes=("x", "y"), **kw)
    _same_hierarchy(h1, h2)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_api_solve_axes_routes():
    """mgcg and refined take 2-D ``axes=`` with ``mesh=`` (mgcg at the 1-D
    count; mg_bicgstab's route above); a method that takes no ``axes=``
    raises the JAX facade's ``TypeError``, and its host solves ignore
    it."""
    s = tgen.poisson_system(GRID)
    m2, m1 = _mesh2(2, 4), _mesh(8)
    opts = dict(tol=1e-10, norm="rel_l2", dtype=np.float64)
    a = api.solve(s.A, s.b, method="mgcg", grid=GRID, mesh=m2, axes=("x", "y"), **opts)
    b = api.solve(s.A, s.b, method="mgcg", grid=GRID, mesh=m1, **opts)
    assert a.converged and a.iterations == b.iterations and _rel(a.x.numpy(), b.x.numpy()) <= X_REL
    r = api.solve(s.A, s.b, method="refined", grid=GRID, mesh=m2, axes=("x", "y"), tol=1e-10)
    assert r.converged and np.linalg.norm(s.b - oracle.spmv(s.A, r.x)) < 1e-10
    small = tgen.poisson_system((16, 16))
    jsmall = jgen.poisson_system((16, 16))
    for method, extra in (("cg", {}), ("bicgstab", {}), ("mgcg", dict(grid=(16, 16)))):
        with pytest.raises(TypeError, match="axes"):
            japi.solve(jsmall.A, jsmall.b, method=method, axes=("x",), **extra)
        with pytest.raises(TypeError, match="axes"):
            api.solve(small.A, small.b, method=method, axes=("x",), device="cpu", **extra)
    with pytest.raises(TypeError, match="axes"):
        api.solve(small.A, small.b, method="bicgstab", mesh=_mesh(4), axes=("x",))
    r = api.solve(small.A, small.b, method="oracle", axes=("x",), device="cpu")
    jr = japi.solve(jsmall.A, jsmall.b, method="oracle", axes=("x",))
    assert r.iterations == jr.iterations
