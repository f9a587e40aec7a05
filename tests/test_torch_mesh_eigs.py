"""The eigensolvers over a mesh (``gspmd_lobpcg``, ``gspmd_arnoldi_eigs``,
``arnoldi_eigs(basis_sharding=)``, ``api.eigs(mesh=)``) against the JAX
package and against the port's one-device solvers, on the CPU.

The JAX package places A's DIA data and the blocks row-sharded on its
8-device CPU mesh and lets XLA insert the collectives; the port holds
them as ``Shards`` of row blocks on ``make_mesh(k, devices=["cpu"] * k)``,
its products kernel #5 / #4 per shard (their twins here), its Gram
products, projections and norms ``psum``s.  fp64.

- Three JAX programs: ``gspmd_lobpcg`` on ``banded_sin_matrix(512, 12)``
  k = 4 over 8 shards from the JAX draws (``tests/test_lobpcg.py:
  101-119``): eigenvalues within EIG_REL, iterations within ITS_SLACK
  (``tests/test_torch_lobpcg.py``); ``gspmd_arnoldi_eigs`` on the
  convection operator ``CD`` of ``tests/test_arnoldi.py`` (``:187-193``):
  values within 1e-7 as sets; ``eigs(mesh=, grid=)`` by LOBPCG: values
  within EIG_REL.
- The port's mesh twins against its own one-device solvers from the same
  start: LOBPCG's trajectory (iterations within ITS_SLACK, values within
  EIG_REL), Arnoldi's (the same matvecs and restarts, values within
  1e-10), the generalized problem against ``scipy.linalg.eigh`` (1e-8),
  shift-invert by sharded IDR(4), and ``api.eigs(mesh=)`` on both routes,
  the grid's sharded V-cycle and, where the grid does not divide the
  mesh, the one-device block V-cycle.
- The refusals: a non-DIA A or B (``TypeError``, as in JAX), a row count
  that does not divide the mesh and a missing mesh (``ValueError``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg as sla
import torch

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.solvers.arnoldi import gspmd_arnoldi_eigs as j_gspmd_arnoldi
from conjugategradient_tpu.solvers.lobpcg import gspmd_lobpcg as j_gspmd_lobpcg
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import lobpcg_draws_from_reference
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.parallel import make_mesh
from conjugategradient_tpu_torch.parallel.mesh import Mesh
from conjugategradient_tpu_torch.solvers.arnoldi import arnoldi_eigs, gspmd_arnoldi_eigs
from conjugategradient_tpu_torch.solvers.lobpcg import gspmd_lobpcg, lobpcg

#: fp64 eigenvalues of two solves, relative (tests/test_torch_lobpcg.py)
EIG_REL = 1e-8
#: |iterations - reference| / reference where rounding decides the count
#: (tests/test_torch_lobpcg.py: the trajectories part at about iteration
#: 30, and the JAX package's own count moves as much under a one-ulp
#: change of X0)
ITS_SLACK = 0.1
CD = tgen.convection_diffusion_matrix((16, 16), eps=0.1)


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


def _jA(A):
    return jfmt.DiaMatrix(A.data, A.offsets, A.shape)


def _draws(n, k, seed=0):
    X0 = jax.random.normal(jax.random.PRNGKey(seed), (n, k), jnp.float64)
    P0 = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, k), jnp.float64)
    return lobpcg_draws_from_reference(X0, P0, device="cpu")


def _as_set(v):
    return np.sort_complex(np.asarray(v))


def _its_close(a, b):
    return abs(a - b) <= ITS_SLACK * b


def test_gspmd_lobpcg_matches_jax_and_the_one_device_trajectory():
    A = tgen.banded_sin_matrix(512, 12)
    k = 4
    kw = dict(tol=1e-9, max_iterations=600)
    jr = j_gspmd_lobpcg(_jA(A), k, j_mesh(8), dtype=jnp.float64, seed=0, **kw)
    X0, P0 = _draws(A.shape[0], k)
    r = gspmd_lobpcg(A, k, _mesh(8), X0=X0, P0=P0, dtype=torch.float64, **kw)
    one = lobpcg(A, k, X0=X0, P0=P0, dtype=torch.float64, device="cpu", **kw)
    assert bool(jr.converged) and r.converged and one.converged
    lam = r.eigenvalues.numpy()
    np.testing.assert_allclose(lam, np.asarray(jr.eigenvalues), rtol=EIG_REL)
    np.testing.assert_allclose(lam, one.eigenvalues.numpy(), rtol=EIG_REL)
    assert _its_close(r.iterations, int(jr.iterations)) and _its_close(r.iterations,
                                                                        one.iterations)
    X = r.eigenvectors.numpy()
    assert X.shape == (A.shape[0], k)
    assert np.abs(X.T @ X - np.eye(k)).max() <= 1e-8


def test_gspmd_lobpcg_generalized_matches_eigh():
    A = tgen.poisson2d_matrix(16, 16)
    B = tgen.tridiagonal_matrix(A.n, diag=4.0 / 6.0, off=1.0 / 6.0)
    r = gspmd_lobpcg(A, 3, _mesh(8), B=B, tol=1e-8, dtype=torch.float64, max_iterations=600)
    assert r.converged
    w = sla.eigh(tfmt.dia_to_dense(A).data, tfmt.dia_to_dense(B).data, eigvals_only=True)[:3]
    assert np.abs(r.eigenvalues.numpy() - w).max() / w[0] < 1e-8


def test_gspmd_arnoldi_matches_jax_and_the_one_device_run():
    r8 = gspmd_arnoldi_eigs(CD, k=3, mesh=_mesh(8), which="LM", tol=1e-9)
    j8 = j_gspmd_arnoldi(_jA(CD), k=3, mesh=j_mesh(8), which="LM", tol=1e-9)
    one = arnoldi_eigs(CD, k=3, which="LM", tol=1e-9, device="cpu")
    assert r8.converged and j8.converged and one.converged
    assert np.max(np.abs(_as_set(r8.values) - _as_set(j8.values))) < 1e-7
    assert (r8.matvecs, r8.restarts) == (one.matvecs, one.restarts)
    assert np.max(np.abs(_as_set(r8.values) - _as_set(one.values))) < 1e-10
    # the same route through arnoldi_eigs(basis_sharding=(mesh, axis))
    m4 = _mesh(4)
    r4 = arnoldi_eigs(CD, k=3, which="LM", tol=1e-9, basis_sharding=(m4, m4.axis),
                      dtype=torch.float64)
    assert r4.converged and np.max(np.abs(_as_set(r4.values) - _as_set(one.values))) < 1e-10


def test_shift_invert_over_a_mesh_matches_the_one_device_run():
    """sigma = 0.05 on the 8^2 convection operator: the inner IDR(4) solves
    run as the sharded loop (the same global shadow), the values mapped
    back and the residuals recomputed by kernel #5 a shard."""
    A = tgen.convection_diffusion_matrix((8, 8), eps=0.1)
    kw = dict(k=2, sigma=0.05, tol=1e-9)
    r = gspmd_arnoldi_eigs(A, mesh=_mesh(4), **kw)
    one = arnoldi_eigs(A, device="cpu", **kw)
    assert r.converged and r.inner_converged and one.converged
    assert r.restarts == one.restarts
    assert abs(r.inner_matvecs - one.inner_matvecs) <= 0.05 * one.inner_matvecs
    assert np.max(np.abs(_as_set(r.values) - _as_set(one.values))) < 1e-9
    assert np.max(r.residuals) < 1e-7


def test_eigs_mesh_routes():
    """``api.eigs(mesh=)``: LOBPCG with the grid's sharded V-cycle against
    the JAX facade's (values) and the port's one-device eigs (values,
    counts within ITS_SLACK), the odd grid's replicated cycle, and the
    Arnoldi route against the one-device one."""
    s = tgen.poisson_system((64, 64))
    kw = dict(k=3, which="SM", grid=(64, 64), spd=True, dtype=torch.float64)
    r = api.eigs(s.A, mesh=_mesh(8), **kw)
    one = api.eigs(s.A, device="cpu", **kw)
    jr = japi.eigs(jgen.poisson_system((64, 64)).A, k=3, which="SM", grid=(64, 64),
                   mesh=j_mesh(8), spd=True, dtype=jnp.float64)
    assert r.converged and one.converged and bool(jr.converged)
    np.testing.assert_allclose(r.values.real, np.asarray(jr.values).real, rtol=EIG_REL)
    np.testing.assert_allclose(r.values.real, one.values.real, rtol=EIG_REL)
    assert _its_close(r.restarts, one.restarts)
    assert r.restarts < 60  # the V-cycle preconditions: plain LOBPCG takes hundreds
    so = tgen.poisson_system((63, 63))
    kw.update(grid=(63, 63))
    r = api.eigs(so.A, mesh=_mesh(7), **kw)
    one = api.eigs(so.A, device="cpu", **kw)
    assert r.converged and _its_close(r.restarts, one.restarts)
    np.testing.assert_allclose(r.values.real, one.values.real, rtol=EIG_REL)
    a = api.eigs(CD, k=3, mesh=_mesh(4))
    b = api.eigs(CD, k=3, device="cpu")
    assert a.converged and (a.matvecs, a.restarts) == (b.matvecs, b.restarts)
    assert np.max(np.abs(_as_set(a.values) - _as_set(b.values))) < 1e-10


def test_mesh_eig_refusals():
    A = tgen.poisson2d_matrix(16, 16)
    st = tfmt.dia_to_stencil(A, (16, 16))
    m = _mesh(4)
    with pytest.raises(TypeError, match="DiaMatrix"):
        j_gspmd_lobpcg(jfmt.dia_to_stencil(_jA(A), (16, 16)), 2, j_mesh(4))
    with pytest.raises(TypeError, match="DiaMatrix"):
        gspmd_lobpcg(st, 2, m)
    with pytest.raises(TypeError, match="DiaMatrix B"):
        gspmd_lobpcg(A, 2, m, B=st)
    with pytest.raises(TypeError, match="DiaMatrix"):
        gspmd_arnoldi_eigs(st, k=2, mesh=m)
    with pytest.raises(ValueError, match="needs a mesh"):
        gspmd_arnoldi_eigs(A, k=2)
    odd = tgen.banded_sin_matrix(514, 4)
    with pytest.raises(ValueError, match="divide"):
        gspmd_lobpcg(odd, 2, m)
    with pytest.raises(ValueError, match="divide"):
        gspmd_arnoldi_eigs(odd, k=2, mesh=m)
    with pytest.raises(ValueError, match="1-D mesh"):
        gspmd_lobpcg(A, 2, Mesh([["cpu"] * 2] * 2, ("x", "y")))
