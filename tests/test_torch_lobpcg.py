"""LOBPCG of the port against the JAX package, on the CPU.

The same host matrices (the generators make them bit-identical) and the
JAX package's own random draws (``X0`` from ``PRNGKey(seed)``, ``P0`` from
``PRNGKey(seed + 1)``, carried across by
``convert.lobpcg_draws_from_reference``) go through
``conjugategradient_tpu.solvers.lobpcg.lobpcg`` and the port's
``solvers.lobpcg.lobpcg``: fp64 eigenvalues within EIG_REL, eigenvectors as
subspaces within SUBSPACE, iteration counts equal on the 1-D Laplacian and
within the JAX package's own one-ulp spread elsewhere (see ITS_SLACK).
On the CPU kernel #5 and the V-cycle run their twins.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.precond import multigrid as jmg
from conjugategradient_tpu.solvers.lobpcg import lobpcg as j_lobpcg
from conjugategradient_tpu.solvers.multi import as_multi_preconditioner as j_as_multi
from conjugategradient_tpu_torch.convert import lobpcg_draws_from_reference
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.precond import multigrid as tmg
from conjugategradient_tpu_torch.solvers.lobpcg import gspmd_lobpcg, lobpcg
from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner

#: fp64 eigenvalues of the two packages, relative
EIG_REL = 1e-8
#: ||(I - X_jax X_jax^T) X_port||_2 (B-orthogonal projector when generalized)
SUBSPACE = 1e-6
#: |port - JAX| iterations / JAX iterations where rounding decides the
#: count: the trajectories part at about iteration 30 from reduction
#: rounding, and the JAX package's own count moves as much under a one-ulp
#: change of one entry of X0 (banded_sin 256 band 12 k = 6: 156-180 in six
#: draws; the largest end of 200 band 8: 179-182; measured on the CPU)
ITS_SLACK = 0.1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draws(n, k, dtype=jnp.float64, seed=0):
    """The JAX package's (X0, P0) draws as CPU tensors."""
    X0 = jax.random.normal(jax.random.PRNGKey(seed), (n, k), dtype)
    P0 = jax.random.normal(jax.random.PRNGKey(seed + 1), (n, k), dtype)
    return lobpcg_draws_from_reference(X0, P0, device="cpu")


def _both(jA, tA, k, dtype=jnp.float64, tdtype=torch.float64, jkw=None, tkw=None, **kw):
    """(JAX result, port result) of one solve on the JAX package's draws."""
    n = jA.shape[0]
    X0, P0 = _draws(n, k, dtype)
    rj = j_lobpcg(jA, k, dtype=dtype, **kw, **(jkw or {}))
    rt = lobpcg(tA, k, X0=X0, P0=P0, dtype=tdtype, device="cpu", **kw, **(tkw or {}))
    return rj, rt


def _same_pairs(rj, rt, its="equal", B=None):
    lj, lt = np.asarray(rj.eigenvalues), rt.eigenvalues.numpy()
    assert bool(rj.converged) and rt.converged
    np.testing.assert_allclose(lt, lj, rtol=EIG_REL)
    Xj, Xt = np.asarray(rj.eigenvectors), rt.eigenvectors.numpy()
    BXj = Xj if B is None else B @ Xj
    off = Xt - Xj @ (BXj.T @ Xt)
    assert np.linalg.norm(off, 2) <= SUBSPACE
    ij = int(rj.iterations)
    if its == "equal":
        assert rt.iterations == ij
    else:
        assert abs(rt.iterations - ij) <= ITS_SLACK * ij
    return lt


def test_poisson1d_closed_form_same_iterations():
    n, k = 128, 4
    rj, rt = _both(jgen.poisson1d_matrix(n), tgen.poisson1d_matrix(n), k, tol=1e-10,
                   max_iterations=400)
    lt = _same_pairs(rj, rt)
    exact = 4.0 * np.sin(np.pi * np.arange(1, k + 1) / (2 * (n + 1))) ** 2
    np.testing.assert_allclose(lt, exact, rtol=1e-8)


@pytest.mark.parametrize("shape,k,largest", [((256, 12), 6, False), ((200, 8), 3, True)])
def test_banded_sin_ends(shape, k, largest):
    rj, rt = _both(jgen.banded_sin_matrix(*shape), tgen.banded_sin_matrix(*shape), k, tol=1e-9,
                   max_iterations=600, largest=largest)
    lt = _same_pairs(rj, rt, its="slack")
    dense = np.linalg.eigvalsh(tfmt.dia_to_dense(tgen.banded_sin_matrix(*shape)).data)
    np.testing.assert_allclose(lt, dense[-k:] if largest else dense[:k], rtol=1e-6)


def test_stencil_container_and_orthonormal_vectors():
    """The 2-D grid stencil through ``spmm_columns``; k = 3 takes the
    bottom eigenvalue and the whole multiplicity-2 pair above it."""
    g = (16, 16)
    A = tgen.poisson2d_matrix(16)
    rj, rt = _both(jfmt.dia_to_stencil(jgen.poisson2d_matrix(16), g),
                   tfmt.dia_to_stencil(A, g), 3, tol=1e-9, max_iterations=500)
    _same_pairs(rj, rt, its="slack")
    X = rt.eigenvectors.numpy()
    np.testing.assert_allclose(X.T @ X, np.eye(3), atol=1e-10)
    Ad = tfmt.dia_to_dense(A).data
    assert np.linalg.norm(Ad @ X - X * rt.eigenvalues.numpy(), axis=0).max() < 1e-8


@pytest.mark.parametrize("with_m", [False, True])
def test_generalized_mass_matrix(with_m):
    """A x = lambda B x with the tridiagonal mass matrix (4/6, 1/6), plain
    (20^2) and with a V-cycle M (31^2): B-orthonormal vectors, the dense
    generalized eigenvalues."""
    import scipy.linalg as sla

    grid = (31, 31) if with_m else (20, 20)
    k = 3 if with_m else 4
    sj, st = jgen.poisson_system(grid), tgen.poisson_system(grid)
    n = st.n
    Bj = jgen.tridiagonal_matrix(n, diag=4.0 / 6.0, off=1.0 / 6.0)
    Bt = tgen.tridiagonal_matrix(n, diag=4.0 / 6.0, off=1.0 / 6.0)
    jkw, tkw = dict(B=Bj), dict(B=Bt)
    if with_m:
        jkw["M"] = j_as_multi(jmg.build_hierarchy(sj.A, grid, dtype=np.float64))
        tkw["M"] = as_multi_preconditioner(tmg.build_hierarchy(st.A, grid, dtype=np.float64,
                                                               device="cpu"))
    rj, rt = _both(sj.A, st.A, k, tol=1e-8, max_iterations=500, jkw=jkw, tkw=tkw)
    Bd = tfmt.dia_to_dense(Bt).data
    lt = _same_pairs(rj, rt, its="slack", B=Bd)
    w = sla.eigh(tfmt.dia_to_dense(st.A).data, Bd, eigvals_only=True)[:k]
    assert np.abs(lt - w).max() / w[0] < 1e-8
    X = rt.eigenvectors.numpy()
    assert np.abs(X.T @ Bd @ X - np.eye(k)).max() < 1e-10
    if with_m:  # the V-cycle is the multigrid eigensolver's point
        assert rt.iterations <= 30


def test_fp32_path():
    """fp32 (the default dtype) on the JAX package's fp32 draws: the
    closed form within the JAX test's 1e-2 and the JAX package's values
    within fp32 reach of the tolerance."""
    n, k = 256, 3
    rj, rt = _both(jgen.poisson1d_matrix(n), tgen.poisson1d_matrix(n), k, dtype=jnp.float32,
                   tdtype=torch.float32, tol=1e-4, max_iterations=400)
    assert bool(rj.converged) and rt.converged
    assert rt.eigenvalues.dtype == torch.float32 and rt.eigenvectors.dtype == torch.float32
    exact = 4.0 * np.sin(np.pi * np.arange(1, k + 1) / (2 * (n + 1))) ** 2
    lt = rt.eigenvalues.numpy().astype(np.float64)
    np.testing.assert_allclose(lt, exact, rtol=1e-2)
    np.testing.assert_allclose(lt, np.asarray(rj.eigenvalues, np.float64), rtol=1e-2)


def test_placements_callable_and_refusals():
    """An (n, j) block callable is the container it multiplies by; a
    callable A needs X0; ``gspmd_lobpcg`` runs the same trajectory over 4
    shards and refuses a non-DIA A as the JAX package does."""
    A = tgen.poisson1d_matrix(64)
    X0, P0 = _draws(64, 2)
    kw = dict(X0=X0, P0=P0, dtype=torch.float64, device="cpu", tol=1e-9)
    r1 = lobpcg(A, 2, **kw)
    D = torch.from_numpy(tfmt.dia_to_dense(A).data)
    r3 = lobpcg(lambda X: D @ X, 2, **kw)
    assert r3.iterations == r1.iterations
    np.testing.assert_allclose(r3.eigenvalues.numpy(), r1.eigenvalues.numpy(), rtol=1e-12)
    with pytest.raises(ValueError, match="X0 is required"):
        lobpcg(lambda X: X, 2)
    from conjugategradient_tpu_torch.parallel import make_mesh

    r4 = gspmd_lobpcg(A, 2, make_mesh(4, devices=["cpu"] * 4), **{k: v for k, v in kw.items()
                                                                  if k != "device"})
    assert r4.iterations == r1.iterations
    np.testing.assert_allclose(r4.eigenvalues.numpy(), r1.eigenvalues.numpy(), rtol=1e-12)
    with pytest.raises(TypeError, match="DiaMatrix"):
        gspmd_lobpcg(tfmt.dia_to_stencil(A, (64,)), 2, make_mesh(4, devices=["cpu"] * 4))
