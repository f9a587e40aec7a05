"""The nonsymmetric and indefinite systems of the port against the JAX
package's, on the CPU: every generator bit-identical, ``is_symmetric`` with
the tolerance ``method="auto"`` probes at (``1e-12 * max|diag|``) giving the
same verdict, and the geometric hierarchy of a convection-diffusion
operator (rediscretized by ``convection_diffusion_coarse_operator`` or
Galerkin, Jacobi or Chebyshev smoothing) bit-identical to the JAX build."""

import numpy as np
import pytest
import torch

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.precond import multigrid as tmg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_dia(a, b):
    assert a.offsets == b.offsets and a.shape == b.shape
    u, v = np.asarray(a.data), np.asarray(b.data)
    assert u.dtype == v.dtype and np.array_equal(u, v)


def _same_system(a, b):
    _same_dia(a.A, b.A)
    for u, v in ((a.b, b.b), (a.x0, b.x0)):
        u, v = np.asarray(u), np.asarray(v)
        assert u.dtype == v.dtype and np.array_equal(u, v)


CONVECTION = [((15, 15), 0.05, "upwind", "recirculating"),
              ((31, 24), 1.0, "central", "recirculating"),
              ((17, 19), 0.5, "upwind", (0.3, -0.7)),
              ((7, 9, 11), 0.05, "upwind", "recirculating"),
              ((6, 5, 4), 1.0, "central", (0.2, 0.1, -0.4))]


@pytest.mark.parametrize("grid,eps,scheme,velocity", CONVECTION)
def test_convection_diffusion_bit_identical(grid, eps, scheme, velocity):
    kw = dict(eps=eps, scheme=scheme, velocity=velocity)
    for dt in (np.float64, np.float32):
        _same_dia(tgen.convection_diffusion_matrix(grid, dtype=dt, **kw),
                  jgen.convection_diffusion_matrix(grid, dtype=dt, **kw))
    rows = tgen.convection_diffusion_rows if len(grid) == 2 else tgen.convection_diffusion3d_rows
    jrows = jgen.convection_diffusion_rows if len(grid) == 2 else jgen.convection_diffusion3d_rows
    n = int(np.prod(grid))
    ot, dt_ = rows(grid, n // 3, n - 5, **kw)
    oj, dj = jrows(grid, n // 3, n - 5, **kw)
    assert ot == oj and np.array_equal(dt_, dj)
    if velocity == "recirculating":
        _same_system(tgen.convection_diffusion_system(grid, eps=eps, scheme=scheme, seed=2),
                     jgen.convection_diffusion_system(grid, eps=eps, scheme=scheme, seed=2))
        ct = tgen.convection_diffusion_coarse_operator(eps, scheme=scheme)
        cj = jgen.convection_diffusion_coarse_operator(eps, scheme=scheme)
        coarse = tuple((g - 1) // 2 for g in grid)
        for level in (1, 2):
            _same_dia(ct(level, coarse), cj(level, coarse))
    with pytest.raises(ValueError, match="scheme"):
        tgen.convection_diffusion_matrix(grid, scheme="nope")


@pytest.mark.parametrize("grid", [(40,), (24, 24), (7, 6, 5)])
def test_helmholtz_bit_identical(grid):
    for dt in (np.float64, np.float32):
        _same_system(tgen.helmholtz_system(grid, 0.7, seed=1, dtype=dt),
                     jgen.helmholtz_system(grid, 0.7, seed=1, dtype=dt))
    n = int(np.prod(grid))
    ot, dt_ = tgen.helmholtz_rows(grid, 0.3, 3, n - 2)
    oj, dj = jgen.helmholtz_rows(grid, 0.3, 3, n - 2)
    assert ot == oj and np.array_equal(dt_, dj)


def test_nonsymmetric_banded_bit_identical():
    for n, band, dt in ((512, 8, np.float64), (333, 16, np.float32), (2, 2, np.float64)):
        _same_system(tgen.nonsymmetric_banded_system(n, band, dtype=dt),
                     jgen.nonsymmetric_banded_system(n, band, dtype=dt))
    with pytest.raises(ValueError, match="band"):
        tgen.nonsymmetric_banded_matrix(10, 7)


def _symmetry_cases():
    """(label, port matrix, JAX matrix, expected verdict)."""
    out = []
    for grid, eps, scheme, velocity in CONVECTION[:3]:
        kw = dict(eps=eps, scheme=scheme, velocity=velocity)
        out.append((f"convection {grid} {scheme}", tgen.convection_diffusion_matrix(grid, **kw),
                    jgen.convection_diffusion_matrix(grid, **kw), False))
    out.append(("nonsymmetric band 512 x 8", tgen.nonsymmetric_banded_matrix(512, 8),
                jgen.nonsymmetric_banded_matrix(512, 8), False))
    out.append(("helmholtz 24^2", tgen.helmholtz_matrix((24, 24), 1.5),
                jgen.helmholtz_matrix((24, 24), 1.5), True))
    out.append(("banded sin 512 x 8", tgen.banded_sin_matrix(512, 8),
                jgen.banded_sin_matrix(512, 8), True))
    # eps -> infinity limit: a symmetric Laplacian plus a skew part at the
    # probe's own tolerance scale
    A = tgen.convection_diffusion_matrix((9, 9), eps=1e13, scheme="central")
    out.append(("central eps 1e13 (skew part at 1e-13 max|diag|)", A,
                jgen.convection_diffusion_matrix((9, 9), eps=1e13, scheme="central"), True))
    return out


@pytest.mark.parametrize("case", range(len(_symmetry_cases())))
def test_is_symmetric_matches_jax_at_the_auto_tolerance(case):
    label, At, Aj, want = _symmetry_cases()[case]
    tol_t = 1e-12 * float(np.max(np.abs(tfmt.matrix_diagonal(At))))
    tol_j = 1e-12 * float(np.max(np.abs(jfmt.matrix_diagonal(Aj))))
    assert tol_t == tol_j
    got = tfmt.is_symmetric(At, tol=tol_t)
    assert got == jfmt.is_symmetric(Aj, tol=tol_j) == want, label
    # every container of the port gives the DIA's verdict
    csr = tfmt.dia_to_csr(At)
    for A in (csr, tfmt.csr_to_ell(csr), tfmt.csr_to_dense(csr)):
        assert tfmt.is_symmetric(A, tol=tol_t) == want, (label, type(A).__name__)


#: (grid, eps, scheme, build keywords)
HIERARCHIES = {
    "31^2 eps 0.05 rediscretized, jacobi": (
        (31, 31), 0.05, "upwind", dict(smoother="jacobi", max_coarse=20, redisc=True)),
    "31^2 eps 0.05 rediscretized, chebyshev": (
        (31, 31), 0.05, "upwind", dict(max_coarse=20, redisc=True)),
    "15^2 eps 1.0 central Galerkin, jacobi": (
        (15, 15), 1.0, "central", dict(smoother="jacobi", max_coarse=20)),
}


@pytest.mark.parametrize("case", sorted(HIERARCHIES))
def test_convection_hierarchy_bit_identical_to_jax(case):
    grid, eps, scheme, kw = HIERARCHIES[case]
    kw = dict(kw)
    if kw.pop("redisc", False):
        kt = dict(kw, coarse_operator=tgen.convection_diffusion_coarse_operator(eps))
        kj = dict(kw, coarse_operator=jgen.convection_diffusion_coarse_operator(eps))
    else:
        kt = kj = kw
    At = tgen.convection_diffusion_matrix(grid, eps=eps, scheme=scheme)
    Aj = jgen.convection_diffusion_matrix(grid, eps=eps, scheme=scheme)
    ht = tmg.build_hierarchy(At, grid, device="cpu", **kt)
    hj = jmg.build_hierarchy(Aj, grid, **kj)
    assert len(ht.levels) == len(hj.levels) >= 2
    for lt, lj in zip(ht.levels, hj.levels):
        assert (lt.grid, lt.transfer, lt.cheb_bounds) == (lj.grid, lj.transfer, lj.cheb_bounds)
        assert type(lt.A).__name__ == type(lj.A).__name__ == "StencilMatrix"
        assert lt.A.shifts == lj.A.shifts
        np.testing.assert_array_equal(lt.A.data.numpy(), np.asarray(lj.A.data))
        np.testing.assert_array_equal(lt.inv_diag.numpy(), np.asarray(lj.inv_diag))
    np.testing.assert_array_equal(ht.coarse_inv.numpy(), np.asarray(hj.coarse_inv))
    # the V-cycle of the carried-over fields equals the JAX cycle
    r = np.random.default_rng(4).standard_normal(At.n)
    zt = tmg.v_cycle(ht, torch.from_numpy(r.reshape(grid))).numpy()
    zj = np.asarray(jmg.v_cycle(hj, np.asarray(r.reshape(grid))))
    assert np.abs(zt - zj).max() <= 1e-12 * np.abs(zj).max()
