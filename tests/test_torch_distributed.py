"""The port's distributed setup (``precond.distributed``) against the port's
host build, on the CPU.

``build_hierarchy_probed`` builds on the shards the hierarchy that
``precond.multigrid.build_hierarchy(..., layout="stencil",
sa_smooth_levels=0)`` builds on the host; that host build is held to the
JAX package's bit for bit (``tests/test_torch_mg_kinds.py``), so most cases
here hold the probed build to it and compile no JAX program
(``tests/test_torch_rung5.py`` holds one probed build, the rediscretized
build and the rung-5 solves to the JAX package's).  The meshes are
``make_mesh(k, devices=["cpu"] * k)``: k shards of one device, kernel #3's
twin for every product.  In fp64:

- the same level grids, transfers and pruned leg sets; legs, aggregation
  weights and ``inv_diag`` within 1e-12; ``coarse_inv`` within 1e-10;
- on 1, 2 and 4 shards, by the hybrid and the aggregation transfers, with
  a probed level whose local axis-0 extent is not a multiple of its
  probing period (a shard-local index would give wrong legs there, and
  nothing would raise);
- ``build_hierarchy_redisc``'s levels equal the host rediscretized build's
  bit for bit;
- a sharded level reaches ``make_shard_vcycle`` as the builder placed it
  (the same ``Shards``, the same leg storage), and the cycle refuses
  smoother settings other than the hierarchy's;
- an identity-padded odd grid's padded plane solves to exactly 0.
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.core.formats import StencilMatrix, stencil_to_dia
from conjugategradient_tpu_torch.parallel import make_mesh, rung5
from conjugategradient_tpu_torch.parallel.shard_mgcg import ShardHierarchy, make_shard_vcycle
from conjugategradient_tpu_torch.precond import distributed as dist
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: probed against host Galerkin legs, weights, inv_diag (fp64)
LEG_ABS = 1e-12
#: the dense coarse inverses
INV_ABS = 1e-10
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=500)


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


def _shard_legs(L):
    """A sharded level's global legs: each shard's middle rows of its
    extended slab, in shard order."""
    op = L.op
    H, n0 = op.halo, op.local[0]
    return torch.cat([m.data[:, H:H + n0] for m in op.mats.parts], dim=1).numpy()


def _levels(h: ShardHierarchy):
    """Every level of a probed hierarchy as host arrays: (grid, kind,
    shifts, legs, inv_diag, weight or None), sharded levels gathered."""
    out = [(L.grid, L.kind, L.op.shifts, _shard_legs(L), L.inv_diag.gather(0).numpy(),
            None if L.weight is None else L.weight.gather(0).numpy()) for L in h.levels]
    out += [(L.grid, L.transfer, L.A.shifts, L.A.data.numpy(), L.inv_diag.numpy(),
             None if L.weight is None else L.weight.numpy()) for L in h.tail.levels]
    return out


def _host_build(A, padded, **kw):
    legs = A.data.gather(1).numpy()
    return build_hierarchy(stencil_to_dia(StencilMatrix(legs, A.shifts, padded)), padded,
                           sa_smooth_levels=0, layout="stencil", dtype=np.float64,
                           const_detect=False, device="cpu", **kw)


#: (label, grid, shards, transfer_kind, max_coarse)
CASES = [
    ("hyb then agg, 4 shards, a replicated tail", (14, 16), 4, "auto", 8),
    ("1-D, 4 shards", (29,), 4, "auto", 8),
    ("3-D agg, 4 shards", (6, 7, 8), 4, "auto", 8),
    ("agg, 2 shards", (16, 16), 2, "agg", 8),
    ("hyb, 2 shards", (32, 20), 2, "hyb", 50),
    ("one device", (14, 16), 1, "auto", 8),
    ("hyb, coarse local extent 4 against period 5", (32, 24), 4, "auto", 40),
    ("agg, coarse local extent 4 against period 3", (32, 24), 4, "agg", 40),
]


@pytest.mark.parametrize("label,grid,num,kind,max_coarse", CASES, ids=[c[0] for c in CASES])
def test_probed_matches_the_host_build(label, grid, num, kind, max_coarse):
    mesh = _mesh(num)
    A, b, x0, padded, n_real = rung5.make_rung5_system(grid, mesh, dtype=np.float64)
    h = dist.build_hierarchy_probed(A, mesh, max_coarse=max_coarse, transfer_kind=kind)
    hh = _host_build(A, padded, max_coarse=max_coarse, transfer_kind=kind)
    got = _levels(h)
    assert len(got) == len(hh.levels) >= 2
    assert h.levels, f"{label}: no level shards"
    for (g, k, shifts, legs, inv, w), lh in zip(got, hh.levels):
        assert g == lh.grid and k == lh.transfer
        assert tuple(shifts) == tuple(lh.A.shifts), f"{label} {g}: leg sets differ"
        np.testing.assert_allclose(legs, lh.A.data.numpy(), rtol=0, atol=LEG_ABS)
        np.testing.assert_allclose(inv.reshape(-1), lh.inv_diag.numpy().reshape(-1), rtol=0,
                                   atol=LEG_ABS)
        assert (w is None) == (lh.weight is None)
        if w is not None:
            np.testing.assert_allclose(w.reshape(-1), lh.weight.numpy().reshape(-1), rtol=0,
                                       atol=LEG_ABS)
    np.testing.assert_allclose(h.coarse_inv.numpy(), hh.coarse_inv.numpy(), rtol=0, atol=INV_ABS)
    assert h.host_reads == 2 * (len(h.levels) + len(h.tail.levels)) + 1
    assert [(g, k) for g, _, _, k in h.near_null] == [(L.grid, L.transfer) for L in hh.levels]
    assert h.real0 == grid[0]


def test_the_period_cases_probe_a_level_whose_local_extent_is_off_period():
    """The last two cases pin the global-index hazard: a sharded level is
    probed whose coarse local axis-0 extent (4) is no multiple of its
    period (5 on the cc axis, 3 under aggregation)."""
    for kind, period in (("auto", 5), ("agg", 3)):
        mesh = _mesh(4)
        A, *_ = rung5.make_rung5_system((32, 24), mesh, dtype=np.float64)
        h = dist.build_hierarchy_probed(A, mesh, max_coarse=40, transfer_kind=kind)
        L = h.levels[0]
        gc, periods, _ = dist._probe_geometry(L.grid, L.kind)
        assert periods[0] == period and (gc[0] // 4) % period != 0
        assert len(h.levels) >= 2  # the coarse level is sharded too


def test_sharded_levels_reach_the_vcycle_as_placed():
    """No gather, no second copy: the fine level's extended legs are the
    slabs the assembly filled, ``make_shard_vcycle`` takes the builder's
    ``ShardLevel``s themselves, and the outer product shares their legs.
    Settings that differ from the hierarchy's raise."""
    mesh = _mesh(4)
    A, b, x0, padded, n_real = rung5.make_rung5_system((30, 16), mesh, dtype=np.float64)
    h = dist.build_hierarchy_probed(A, mesh, max_coarse=32)
    assert len(h.levels) >= 2
    fine = h.levels[0].op
    for slab, part, m in zip(A.slabs.parts, A.data.parts, fine.mats.parts):
        assert m.data.data_ptr() == slab.data_ptr() and part._base is slab
    before = [[m.data.data_ptr() for m in L.op.mats.parts] for L in h.levels]
    M = make_shard_vcycle(None, padded, mesh, hierarchy=h)
    assert M.levels is h.levels and M.hierarchy is h
    assert [[m.data.data_ptr() for m in L.op.mats.parts] for L in M.levels] == before
    assert all(isinstance(L.inv_diag, type(b)) for L in M.levels)
    assert [m.data.data_ptr() for m in M.op.mats.parts] == before[0]
    with pytest.raises(ValueError, match="built for"):
        make_shard_vcycle(None, padded, _mesh(2), hierarchy=h)
    M = make_shard_vcycle(None, padded, mesh, smoother="chebyshev", pre=2, post=2,
                          dtype=np.float64, hierarchy=h)
    assert M.levels is h.levels
    for kw in (dict(smoother="jacobi"), dict(pre=1), dict(dtype=np.float32)):
        with pytest.raises(ValueError, match="differ from the given hierarchy"):
            make_shard_vcycle(None, padded, mesh, hierarchy=h, **kw)


@pytest.mark.parametrize("num", [1, 2, 4])
def test_redisc_matches_the_host_rediscretized_build(num):
    """Every level generated slab by slab equals the host rediscretized
    build's legs bit for bit (the same closed-form generator)."""
    grid = (32, 32)
    s = generators.convection_diffusion_system(grid, eps=0.05, dtype=np.float64)
    hh = build_hierarchy(s.A, grid, smoother="jacobi", max_coarse=60, const_detect=False,
                         coarse_operator=generators.convection_diffusion_coarse_operator(0.05),
                         dtype=np.float64, device="cpu")
    slab = generators.convection_diffusion_level_slab(0.05, dtype=np.float64)
    h = dist.build_hierarchy_redisc(grid, _mesh(num), slab, max_coarse=60, dtype=np.float64)
    got = [(L.grid, L.kind, _shard_legs(L), L.inv_diag.gather(0).numpy()) for L in h.levels]
    got += [(L.grid, L.transfer, L.A.data.numpy(), L.inv_diag.numpy()) for L in h.tail.levels]
    assert len(got) == len(hh.levels) and h.levels
    for (g, k, legs, inv), lh in zip(got, hh.levels):
        assert g == lh.grid and k == lh.transfer == "hyb"
        np.testing.assert_array_equal(legs, lh.A.data.numpy())
        np.testing.assert_array_equal(inv, lh.inv_diag.numpy())
    np.testing.assert_allclose(h.coarse_inv.numpy(), hh.coarse_inv.numpy(), rtol=0, atol=1e-12)


def test_padded_odd_grid_solves_to_zero_on_its_padded_plane():
    """(13, 6) on 4 shards pads axis 0 to 16 identity rows.  Plain CG and
    MGCG (its V-cycle's output masked there, the hierarchy's ``real0``)
    leave those rows exactly 0; the real rows solve the unpadded Poisson
    system."""
    mesh = _mesh(4)
    grid = (13, 6)
    A, b, x0, padded, n_real = rung5.make_rung5_system(grid, mesh, dtype=np.float64)
    assert padded == (16, 6)
    h = dist.build_hierarchy_probed(A, mesh, max_coarse=8)
    assert A.real0 == h.real0 == grid[0] and n_real == grid[0] * grid[1]
    pol = ConvergencePolicy(**POL)
    s = generators.poisson_system(grid)
    for res in (rung5.make_rung5_cg(pol)(A, b, x0), rung5.make_rung5_mgcg(pol, h)(b, x0)):
        assert res.converged
        x = res.x.gather().numpy()
        assert np.all(x[grid[0]:] == 0.0)
        r = s.b - oracle.spmv(s.A, x[:grid[0]].reshape(-1))
        assert np.linalg.norm(r) / np.linalg.norm(s.b) < 1e-9


def test_setup_products_are_the_probes_and_the_power_iteration():
    """Each level's stencil products: the probes (the product of its
    periods), the power iteration's and the two Rayleigh quotients', once
    a shard (``setup_products``, what the card's launch count is held to)."""
    mesh = _mesh(4)
    A, *_ = rung5.make_rung5_system((30, 31, 31), mesh, dtype=np.float64)
    h = dist.build_hierarchy_probed(A, mesh, max_coarse=129, power_iters=5)
    kinds = [L.kind for L in h.levels] + [L.transfer for L in h.tail.levels]
    want = []
    for L, kind in zip(list(h.levels) + list(h.tail.levels), kinds):
        _, periods, _ = dist._probe_geometry(L.grid, kind)
        want.append((L.grid, 4 if isinstance(L, type(h.levels[0])) else 1,
                     int(np.prod(periods)) + 5 + 2))
    assert list(h.setup_products) == want
    assert kinds[0] == "hyb" and want[0][2] == 45 + 7


def test_refusals():
    mesh = _mesh(2)
    A, *_ = rung5.make_rung5_system((14, 16), mesh, dtype=np.float64)
    with pytest.raises(TypeError):
        dist.build_hierarchy_probed(stencil_to_dia(StencilMatrix(A.data.gather(1).numpy(),
                                                                 A.shifts, A.grid)), mesh)
    with pytest.raises(ValueError, match="unsupported smoother"):
        dist.build_hierarchy_probed(A, mesh, smoother="rbgs")
    with pytest.raises(ValueError, match="transfer_kind"):
        dist.build_hierarchy_probed(A, mesh, transfer_kind="fw")
    wide = StencilMatrix(A.data, tuple((2 * s[0], s[1]) for s in A.shifts), A.grid)
    with pytest.raises(ValueError, match="extent"):
        dist.build_hierarchy_probed(wide, mesh)
    with pytest.raises(ValueError, match="own axes"):
        dist.build_hierarchy_probed(A, mesh, axes=("x", "y"))
    # over a (1, 2) mesh the 2-D blocks split axis 1 (the 1-D build's odd
    # 7-row blocks do not carry its levels, so they build replicated): every
    # level's global legs equal the 1-D build's
    from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards

    def every_level(h):
        out = []
        for L in h.levels:
            op = L.op
            blocks = Shards([op._narrowed(m.data, range(len(op.halos))) for m in op.mats.parts],
                            op.mesh)
            out.append((L.grid, L.kind, op.shifts, blocks.gather_grid(len(L.grid))))
        return out + [(L.grid, L.transfer, L.A.shifts, L.A.data) for L in h.tail.levels]

    h1 = dist.build_hierarchy_probed(A, mesh, max_coarse=40)
    h2 = dist.build_hierarchy_probed(A, Mesh([["cpu"] * 2], ("x", "y")), axes=("x", "y"),
                                     max_coarse=40)
    assert len(h2.levels) >= 1
    l1, l2 = every_level(h1), every_level(h2)
    assert [v[:3] for v in l1] == [v[:3] for v in l2] and len(l1) >= 1
    assert all(torch.equal(a[3], b[3]) for a, b in zip(l1, l2))
    slab = generators.convection_diffusion_level_slab(0.05, dtype=np.float64)
    with pytest.raises(ValueError, match="unsupported smoother"):
        dist.build_hierarchy_redisc((16, 16), mesh, slab, smoother="rbgs")
    with pytest.raises(ValueError, match="no sharded level"):
        rung5.make_rung5_mgcg(ConvergencePolicy(), dist.build_hierarchy_probed(A, mesh,
                                                                             max_coarse=10 ** 4))
