"""Point and block Jacobi, the Chebyshev preconditioners and the eigenvalue
diagnostics of the port against the JAX package's, on the CPU, and the
facade's preconditioned methods in fp64.

The host setup (block inverses, Lanczos, Gershgorin, the condition number,
the spectrum of a CG run, the Chebyshev bounds) is the same numpy code, so
its results are bit-identical; the device applies agree to fp64 rounding;
``jacobi_eigenvalues`` runs the same cyclic rotations; ``power_iteration``
starts from another random vector, so only its eigenvalue is compared.
Every facade method takes the JAX package's iteration count with x within
1e-10.  Inputs are made from numpy seeds and handed to both packages."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.spmv import as_operator as j_as_operator
from conjugategradient_tpu.precond import block_jacobi as jbj
from conjugategradient_tpu.precond import smoothers as jsm
from conjugategradient_tpu.solvers import eigen as jeig
from conjugategradient_tpu.solvers.cg import cg_solve_traced as j_cg_traced
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import dia_to_dense
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.precond import block_jacobi as tbj
from conjugategradient_tpu_torch.precond import smoothers as tsm
from conjugategradient_tpu_torch.solvers import eigen as teig

#: the same recurrence in fp64: x within this, iteration counts equal
X_ABS = 1e-10
#: the same products in another summation order, fp64
APPLY_REL = 1e-13


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops (the Jacobi rotations above all): one intra-op
    thread keeps the suite's parallel workers from oversubscribing the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _banded(n=1000, band=12):
    return tgen.banded_sin_matrix(n, band), jgen.banded_sin_matrix(n, band)


@pytest.mark.parametrize("bs", [7, 8])
def test_block_jacobi_blocks_aux_and_apply(bs):
    """n = 1000: bs = 7 leaves a partial last block (identity rows)."""
    At, Aj = _banded()
    Bt, Bj = tbj.block_jacobi_blocks(At, bs), jbj.block_jacobi_blocks(Aj, bs)
    assert Bt.dtype == Bj.dtype and np.array_equal(Bt, Bj)
    assert np.array_equal(tbj.block_jacobi_aux(At, bs, np.float32),
                          jbj.block_jacobi_aux(Aj, bs, np.float32))
    rng = np.random.default_rng(bs)
    r, R = rng.standard_normal(1000), rng.standard_normal((1000, 3))
    Mt = tbj.block_jacobi_preconditioner(At, bs, device="cpu")
    Mj = jbj.block_jacobi_preconditioner(Aj, bs)
    for v in (r, R):
        want = np.asarray(Mj(jnp.asarray(v)))
        got = Mt(torch.from_numpy(v)).numpy()
        assert got.shape == v.shape
        assert np.abs(got - want).max() <= APPLY_REL * np.abs(want).max()
    if 1000 % bs == 0:
        aux = tbj.block_jacobi_aux(At, bs)
        got = tbj.block_jacobi_M_local(torch.from_numpy(r), torch.from_numpy(aux)).numpy()
        want = np.asarray(jbj.block_jacobi_M_local(jnp.asarray(r), jnp.asarray(aux)))
        assert np.abs(got - want).max() <= APPLY_REL * np.abs(want).max()
    with pytest.raises(ValueError, match="block_size"):
        tbj.block_jacobi_blocks(At, 0)


def test_jacobi_and_chebyshev_preconditioners():
    At, Aj = _banded()
    r = np.random.default_rng(2).standard_normal(1000)
    d = np.asarray(At.data)[At.offsets.index(0)]
    got = tsm.jacobi_preconditioner(torch.from_numpy(1.0 / d))(torch.from_numpy(r)).numpy()
    assert np.array_equal(got, np.asarray(jsm.jacobi_preconditioner(jnp.asarray(1.0 / d))(jnp.asarray(r))))
    Mt, bt = tsm.chebyshev_preconditioner_for(At, degree=3, device="cpu")
    Mj, bj = jsm.chebyshev_preconditioner_for(Aj, degree=3)
    assert bt == bj  # host Lanczos, bit for bit
    want = np.asarray(Mj(jnp.asarray(r)))
    assert np.abs(Mt(torch.from_numpy(r)).numpy() - want).max() <= APPLY_REL * np.abs(want).max()
    lo, hi = bt
    M2 = tsm.chebyshev_preconditioner(as_operator(At.device_put(device="cpu")),
                                      torch.from_numpy(1.0 / d), 2, lo, hi)
    want = np.asarray(jsm.chebyshev_preconditioner(j_as_operator(Aj.device_put()), jnp.asarray(1.0 / d),
                                                   2, lo, hi)(jnp.asarray(r)))
    assert np.abs(M2(torch.from_numpy(r)).numpy() - want).max() <= APPLY_REL * np.abs(want).max()
    for bad in ((0.0, 1.0), (2.0, 1.0)):
        with pytest.raises(ValueError, match="lam_min"):
            tsm.chebyshev_preconditioner(lambda v: v, torch.ones(3), 2, *bad)


def test_host_spectrum_tools_bit_identical():
    At, Aj = _banded(600, 10)
    assert teig.gershgorin_bounds(At) == jeig.gershgorin_bounds(Aj)
    assert teig.gershgorin_bounds(At.device_put(device="cpu")) == jeig.gershgorin_bounds(Aj)
    assert teig.condition_number(At) == jeig.condition_number(Aj)
    assert teig.condition_number(dia_to_dense(At), k=12) == jeig.condition_number(
        jfmt.dia_to_dense(Aj), k=12)
    apply = lambda v: oracle.spmv(At, v)
    for k in (5, 30):
        assert teig.lanczos_bounds(apply, 600, k) == jeig.lanczos_bounds(apply, 600, k)
    s = jgen.poisson_system((15, 15))
    res, _hist, (alphas, betas) = j_cg_traced(s.A.device_put(), jnp.asarray(s.b), num_steps=40,
                                              policy=JPolicy(tol=1e-10), with_coefficients=True)
    alphas, betas = np.asarray(alphas), np.asarray(betas)
    its = int(res.iterations)
    want = jeig.spectrum_from_cg(alphas, betas, its)
    assert teig.spectrum_from_cg(alphas, betas, its) == want
    assert teig.spectrum_from_cg(torch.tensor(alphas), torch.tensor(betas), its) == want
    with pytest.raises(ValueError, match="at least one"):
        teig.spectrum_from_cg(alphas, betas, 0)


def test_jacobi_eigenvalues_and_power_iteration():
    rng = np.random.default_rng(6)
    Q, _ = np.linalg.qr(rng.standard_normal((12, 12)))
    lam = np.concatenate([np.linspace(1.0, 2.0, 11), [10.0]])  # a gapped top
    A = (Q * lam) @ Q.T
    A = 0.5 * (A + A.T)
    want = np.asarray(jeig.jacobi_eigenvalues(jnp.asarray(A)))
    got = teig.jacobi_eigenvalues(A, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
    assert np.abs(got - np.linalg.eigvalsh(A)).max() <= 1e-10 * lam.max()
    At = torch.from_numpy(A)
    assert np.array_equal(teig.jacobi_eigenvalues(At).numpy(), got)
    pj = float(jeig.power_iteration(lambda v: jnp.asarray(A) @ v, 12, iters=60, dtype=jnp.float64))
    pt = float(teig.power_iteration(lambda v: At @ v, 12, iters=60, dtype=torch.float64, device="cpu"))
    assert abs(pt - pj) <= 1e-6 * pj and abs(pt - 10.0) <= 1e-6 * 10.0
    gen = torch.Generator().manual_seed(3)
    p3 = teig.power_iteration(lambda v: At @ v, 12, iters=60, dtype=np.float64, device="cpu",
                              generator=gen)
    assert abs(float(p3) - 10.0) <= 1e-6 * 10.0


#: (method, keywords): the facade's preconditioned single-RHS routes
SINGLE = [("jacobi_cg", {}), ("bjacobi_cg", dict(block_size=7)), ("cheb_cg", dict(degree=2)),
          ("mg_cg", dict(grid=(63, 63)))]


@pytest.mark.parametrize("method,kw", SINGLE, ids=[m for m, _ in SINGLE])
def test_facade_preconditioned_cg_equals_jax(method, kw):
    grid = (63, 63) if method == "mg_cg" else (31, 31)
    sj, st = jgen.poisson_system(grid), tgen.poisson_system(grid)
    opts = dict(method=method, tol=1e-10, norm="rel_l2")
    rj = japi.solve(sj.A, sj.b, **opts, **kw)
    rt = api.solve(st.A, st.b, device="cpu", **opts, **kw)
    assert rt.converged and rt.iterations == int(rj.iterations)
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= X_ABS


@pytest.mark.parametrize("method", ["jacobi_cg", "bjacobi_cg"])
def test_facade_preconditioned_block_cg_equals_jax(method):
    sj, st = jgen.poisson_system((31, 31)), tgen.poisson_system((31, 31))
    B = np.random.default_rng(9).standard_normal((sj.n, 2))
    rj = japi.solve(sj.A, B, method=method, tol=1e-10, norm="rel_l2")
    rt = api.solve(st.A, B, method=method, tol=1e-10, norm="rel_l2", device="cpu")
    np.testing.assert_array_equal(rt.iterations.numpy(), np.asarray(rj.iterations))
    assert bool(rt.converged.all())
    assert np.abs(rt.x.numpy() - np.asarray(rj.x)).max() <= X_ABS
