"""s-step CG of the port (``solvers.cacg``) against the JAX package's and
against ``cg_solve``, on the CPU in fp64.

In exact arithmetic CA-CG's iterates are CG's: on 63^2 Poisson the fp64
iteration count equals the JAX package's and ``cg_solve``'s at s = 1, 2
and 4, and x is within X_REL of the JAX package's.  Also a grid-shaped
right-hand side on the stencil form, a zero right-hand side (no
iteration), the linf refusal, the host reads (two per outer step) and
products (2s per outer step) of the loop, an injected basis, the facade's
``cacg`` and ``jacobi_cacg`` with the JAX prefix guard, and fp32 solves
where the port's fp64 coordinates converge and the JAX package's fp32
ones do not."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.solvers.cacg import cacg_solve as j_cacg
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.ops.spmv import as_operator, prepare
from conjugategradient_tpu_torch.solvers import cacg
from conjugategradient_tpu_torch.solvers.cacg import cacg_solve
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of ||x||
X_REL = 1e-10
GRID = (63, 63)
POL = dict(tol=1e-10, norm="rel_l2")
#: plain cacg on the ill-scaled system: counts within this fraction of the
#: JAX package's (see test_facade_cacg_jacobi_cacg_and_the_prefix_guard)
UNSCALED_SPREAD = 0.01


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def poisson():
    s, sj = tgen.poisson_system(GRID), jgen.poisson_system(GRID)
    cg = cg_solve(s.A, torch.from_numpy(s.b), policy=ConvergencePolicy(**POL))
    return s, sj, cg


def _rel(x, ref) -> float:
    x = (x.numpy() if torch.is_tensor(x) else np.asarray(x)).reshape(-1)
    ref = np.asarray(ref).reshape(-1)
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


@pytest.mark.parametrize("s", [1, 2, 4])
def test_matches_jax_and_cg_iteration_for_iteration(poisson, s):
    sy, sj, cg = poisson
    r = cacg_solve(sy.A, torch.from_numpy(sy.b), policy=ConvergencePolicy(**POL), s=s)
    jr = j_cacg(sj.A.device_put(), jnp.asarray(sj.b), policy=JPolicy(**POL), s=s)
    assert r.converged and bool(jr.converged)
    assert r.iterations == int(jr.iterations) == cg.iterations
    assert _rel(r.x, jr.x) <= X_REL
    np.testing.assert_allclose(float(r.residual), float(jr.residual), rtol=1e-6)


def test_grid_shaped_rhs_zero_rhs_and_linf(poisson):
    sy, _, cg = poisson
    st = formats.dia_to_stencil(sy.A, GRID)
    r = cacg_solve(st, torch.from_numpy(sy.b).reshape(GRID), policy=ConvergencePolicy(**POL), s=4)
    assert r.converged and r.x.shape == GRID
    assert r.iterations == cg.iterations and _rel(r.x, cg.x) <= X_REL
    # a zero residual exits at once (the rr > 0 guard), as cg does
    z = cacg_solve(sy.A, torch.zeros(sy.n, dtype=torch.float64),
                   policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"))
    jz = j_cacg(jgen.poisson_system(GRID).A.device_put(), jnp.zeros(sy.n),
                policy=JPolicy(tol=1e-8, norm="rel_l2"))
    assert z.iterations == int(jz.iterations) == 0
    assert not z.x.any()
    with pytest.raises(ValueError, match="coordinate-space"):
        cacg_solve(sy.A, torch.from_numpy(sy.b), policy=ConvergencePolicy(norm="linf"))
    with pytest.raises(ValueError, match="s must be >= 1"):
        cacg_solve(sy.A, torch.from_numpy(sy.b), s=0)


def test_two_host_reads_and_2s_products_per_outer_step(poisson, monkeypatch):
    """The outer step's reductions are the Gram matrix and the replaced
    residual's dot (each read once); its products the 2s-1 of the basis
    and the replacement."""
    sy, _, _ = poisson
    reads, outer, prods = [], [], []
    loop = cacg.cacg_loop

    def counted(op, b, x0, policy, s, dot, gram, **kw):
        def gram_c(V):
            outer.append(1)
            return gram(V)

        def dot_c(u, v):
            reads.append(1)
            return dot(u, v)

        def op_c(v):
            prods.append(1)
            return op(v)

        return loop(op_c, b, x0, policy, s, dot_c, gram_c, **kw)

    monkeypatch.setattr(cacg, "cacg_loop", counted)
    s = 4
    r = cacg_solve(sy.A, torch.from_numpy(sy.b), policy=ConvergencePolicy(**POL), s=s)
    n_outer = len(outer)
    assert -(-r.iterations // s) <= n_outer
    assert len(reads) == 1 + n_outer  # r0.r0, then one per outer step
    assert len(prods) == 1 + 2 * s * n_outer
    assert r.outer_steps == n_outer  # the result reports the steps it took


def test_injected_basis_replaces_the_operator_products(poisson):
    """``basis=`` builds the Krylov rows instead of the loop's 2s-1 ``op``
    applications: here from the grid stencil form of the same matrix, so
    the loop's own ``op`` runs only for r0 and the replaced residuals, and
    the iterates are the default basis's."""
    sy, _, cg = poisson
    s = 4
    b = torch.from_numpy(sy.b)
    op = as_operator(prepare(sy.A, b.device))
    op_st = as_operator(prepare(formats.dia_to_stencil(sy.A, GRID), b.device))
    built, prods = [], []

    def basis(p, r):
        built.append(1)
        rows = []
        for v, k in ((p.reshape(GRID), s), (r.reshape(GRID), s - 1)):
            rows.append(v.reshape(-1))
            for _ in range(k):
                v = op_st(v)
                rows.append(v.reshape(-1))
        return torch.stack(rows)

    def op_c(v):
        prods.append(1)
        return op(v)

    dot = lambda u, v: torch.dot(u.reshape(-1), v.reshape(-1))
    pol = ConvergencePolicy(**POL)
    r = cacg.cacg_loop(op_c, b, torch.zeros_like(b), pol, s, dot, cacg.gram64, basis=basis)
    ref = cacg_solve(sy.A, b, policy=pol, s=s)
    assert r.converged and r.iterations == ref.iterations == cg.iterations
    assert _rel(r.x, ref.x) <= X_REL
    assert len(built) >= 1 and len(prods) == 1 + len(built)


def test_facade_cacg_jacobi_cacg_and_the_prefix_guard():
    """``jacobi_cacg`` on an ill-scaled banded SPD system (the JAX
    package's test: congruence-scaled by exp(U(-3, 3))): the JAX facade's
    count and x, fewer iterations than plain cacg."""
    rng = np.random.default_rng(3)
    base, jbase = tgen.banded_sin_system(512, 8), jgen.banded_sin_system(512, 8)
    scale = np.exp(rng.uniform(-3, 3, 512))
    data = np.array(base.A.data, copy=True)
    for k, off in enumerate(base.A.offsets):
        col = np.zeros(512)
        lo, hi = max(0, -off), min(512, 512 - off)
        col[lo:hi] = scale[lo + off: hi + off]
        data[k] = data[k] * scale * col
    A = formats.DiaMatrix(data, base.A.offsets, base.A.shape)
    Aj = type(jbase.A)(data, jbase.A.offsets, jbase.A.shape)
    kw = dict(tol=1e-10, norm="rel_l2", max_iteration=20000, s=4)
    out = {}
    for method in ("cacg", "jacobi_cacg"):
        r = api.solve(A, base.b, method=method, device="cpu", **kw)
        jr = japi.solve(Aj, base.b, method=method, **kw)
        assert r.converged and bool(jr.converged)
        if method == "jacobi_cacg":
            assert r.iterations == int(jr.iterations)
            assert _rel(r.x, jr.x) <= X_REL
        else:
            # unscaled, kappa grows by about e^12 and the s = 4 monomial
            # basis amplifies the rounding of the coordinate steps: 4036
            # against the JAX package's 4041 measured
            assert abs(r.iterations - int(jr.iterations)) <= UNSCALED_SPREAD * int(jr.iterations)
            assert _rel(r.x, jr.x) <= 1e-7
        out[method] = r
    assert out["jacobi_cacg"].converged
    assert out["jacobi_cacg"].iterations < out["cacg"].iterations
    x_true = oracle.direct_solve(A, base.b)
    assert _rel(out["jacobi_cacg"].x, x_true) < 1e-7
    s = tgen.tridiagonal_system(16)
    with pytest.raises(ValueError, match="only the jacobi_ prefix"):
        api.solve(s.A, s.b, method="bjacobi_cacg", device="cpu")
    with pytest.raises(TypeError, match="jacobi_cacg requires a DiaMatrix"):
        api.solve(formats.dia_to_csr(s.A), s.b, method="jacobi_cacg", device="cpu")
    with pytest.raises(ValueError, match="does not support"):
        api.solve(s.A, np.stack([s.b, s.b], 1), method="cacg", device="cpu")


@pytest.mark.parametrize("n, band, jax_fails", [(4096, 32, "cacg"), (16384, 160, "jacobi_cacg")])
def test_fp32_coordinates_in_fp64_take_cgs_count(n, band, jax_fails):
    """fp32 solves on banded |sin| systems: the Gram accumulated in fp64 and
    the coordinate steps in fp64 take plain CG's count, plain and Jacobi-
    scaled.  The JAX package's fp32 coordinate recurrence (no fp64 on its
    TPU) is rounding there, and the same inputs show it: its cacg stops
    unconverged with a NaN residual after 145 iterations at (4096, 32), its
    jacobi_cacg unconverged at the 500-iteration cap at (16384, 160)."""
    s = tgen.banded_sin_system(n, band)
    kw = dict(tol=1e-6, norm="rel_l2", dtype=np.float32, max_iteration=500)
    cg = api.solve(s.A, s.b, method="cg", device="cpu", **kw)
    for method in ("cacg", "jacobi_cacg"):
        r = api.solve(s.A, s.b, method=method, s=4, device="cpu", **kw)
        assert r.converged, method
        if method == "cacg":
            assert cg.iterations <= r.iterations < cg.iterations + 4
        rel = np.linalg.norm(s.b - oracle.spmv(s.A, r.x.numpy().astype(np.float64)))
        assert rel / np.linalg.norm(s.b) < 1e-5
    sj = jgen.banded_sin_system(n, band)
    jr = japi.solve(sj.A, sj.b, method=jax_fails, s=4, **kw)
    assert not bool(jr.converged) or not np.isfinite(float(jr.residual))
