"""The port's products and solves on every storage format against the JAX
package's, on the CPU.

- ``ops.spmv.spmv`` and ``ops.spmm.spmm`` of each format against the JAX
  package's XLA products in fp64 (1e-12 relative: the same products, summed
  in another order).
- ``api.solve(method="cg")`` and ``"oracle"`` on each format, single and
  ``(n, 4)`` right-hand sides: the JAX package's iteration counts exactly
  in fp64, x within 1e-10.  Each JAX result is computed once per module.
- ``ops.cuda_dia.make_kernel_operator`` on CSR and ELL against the JAX
  package's ``make_pallas_operator`` in interpret mode (both relay out to
  DIA at setup; the port's runs kernel #4's twin here).
- Plain fp64 CG at its attainable accuracy on the flagship's generator,
  cut to 4096 rows: the JAX package's CG, scipy's and the port's all run
  the policy's 200 iterations and stop with a true residual far above their
  recursive one, within a few times of each other (the products' summation
  order moves it).  ``chip_smoke.py`` reads the full-size flagship against
  scipy's CG, which stands in for the JAX package's there.
- Kernels #4 and #5 past 256 diagonals: the chained launch plan
  (``dia_groups``) emulated launch by launch in fp64 against the twins at
  343 and 1331 diagonals.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import oracle as joracle
from conjugategradient_tpu.ops.spmm import spmm as j_spmm
from conjugategradient_tpu.ops.spmv import spmv as j_spmv
from conjugategradient_tpu.ops.pallas_spmv import make_pallas_operator
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle as toracle
from conjugategradient_tpu_torch.ops import cuda_dia
from conjugategradient_tpu_torch.ops.cuda_dia import (
    dia_groups,
    make_kernel_operator,
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_csr_kernel,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
    spmv_ell_kernel,
)
from conjugategradient_tpu_torch.ops.spmm import spmm
from conjugategradient_tpu_torch.ops.spmv import as_operator, spmv
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi

#: fp64 products summed in another order than XLA's
REL_PRODUCT = 1e-12
#: fp64 solutions of the same recurrence with products summed differently
X_TOL = 1e-10
FORMATS = ["dia", "csr", "ell", "coo", "bsr", "dense"]
N, BAND, K = 256, 16, 4


def _containers(fmt, gen):
    """{format: container} of one banded SPD matrix, in the module ``fmt``'s
    containers."""
    A = gen.banded_sin_matrix(N, BAND)
    csr = fmt.dia_to_csr(A)
    return {"dia": A, "csr": csr, "ell": fmt.csr_to_ell(csr), "coo": fmt.csr_to_coo(csr),
            "bsr": fmt.csr_to_bsr(csr, (8, 8)), "dense": fmt.csr_to_dense(csr)}


TMATS, JMATS = _containers(tfmt, tgen), _containers(jfmt, jgen)
RNG = np.random.default_rng(0)
X1 = RNG.standard_normal(N)
XK = RNG.standard_normal((N, K))
B1 = tgen.banded_sin_system(N, BAND).b
BK = np.stack([B1, np.cos(np.arange(N) / 7.0), np.ones(N), RNG.standard_normal(N)], axis=1)


def _rel(a, ref):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("fmt", FORMATS)
def test_products_match_jax_xla(fmt):
    tA, jA = TMATS[fmt], JMATS[fmt]
    y = spmv(tA, torch.from_numpy(X1))
    assert y.dtype == torch.float64 and tuple(y.shape) == (N,)
    assert _rel(y.numpy(), j_spmv(jA, jnp.asarray(X1))) <= REL_PRODUCT
    assert _rel(as_operator(tA)(torch.from_numpy(X1)).numpy(), toracle.spmv(tA, X1)) <= REL_PRODUCT
    Y = spmm(tA, torch.from_numpy(XK))
    assert tuple(Y.shape) == (N, K)
    assert _rel(Y.numpy(), j_spmm(jA, jnp.asarray(XK))) <= REL_PRODUCT
    # the oracle is the JAX oracle's copy: the same numbers
    np.testing.assert_array_equal(toracle.spmv(tA, X1), joracle.spmv(jA, X1))
    # fp32 data under fp32 state stays fp32
    y32 = spmv(tA.device_put(np.float32, "cpu"), torch.from_numpy(X1.astype(np.float32)))
    assert y32.dtype == torch.float32 and _rel(y32.numpy(), toracle.spmv(tA, X1)) <= 1e-5


@pytest.mark.parametrize("fmt", ["csr", "ell", "coo", "dense"])
def test_rectangular_products_match_jax_xla(fmt):
    import scipy.sparse as sp

    m = sp.random(40, 72, density=0.1, random_state=5, format="csr")
    parts = (m.data, m.indices, m.indptr, m.shape)
    tc, jc = tfmt.csr_from_parts(*parts), jfmt.csr_from_parts(*parts)
    conv = {"csr": lambda f, c: c, "ell": lambda f, c: f.csr_to_ell(c),
            "coo": lambda f, c: f.csr_to_coo(c), "dense": lambda f, c: f.csr_to_dense(c)}[fmt]
    tA, jA = conv(tfmt, tc), conv(jfmt, jc)
    x, X = RNG.standard_normal(72), RNG.standard_normal((72, 3))
    assert _rel(spmv(tA, torch.from_numpy(x)).numpy(), j_spmv(jA, jnp.asarray(x))) <= REL_PRODUCT
    assert _rel(spmm(tA, torch.from_numpy(X)).numpy(), j_spmm(jA, jnp.asarray(X))) <= REL_PRODUCT


def test_coo_duplicates_summed_in_products():
    rows = np.array([0, 2, 0, 1, 2, 0], np.int32)
    cols = np.array([1, 2, 1, 0, 2, 2], np.int32)
    data = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    t, j = tfmt.CooMatrix(data, rows, cols, (3, 3)), jfmt.CooMatrix(data, rows, cols, (3, 3))
    x = np.array([1.0, 10.0, 100.0])
    np.testing.assert_allclose(spmv(t, torch.from_numpy(x)).numpy(), j_spmv(j, jnp.asarray(x)),
                               rtol=REL_PRODUCT)
    np.testing.assert_allclose(spmv(t, torch.from_numpy(x)).numpy(), [640.0, 4.0, 700.0])


@pytest.fixture(scope="module")
def jax_solves():
    """{(format, method, rhs): JAX result}, each solve run once."""
    out = {}
    for fmt in FORMATS:
        for rhs, b in (("single", B1), ("block", BK)):
            out[fmt, "cg", rhs] = japi.solve(JMATS[fmt], b, method="cg", tol=1e-8, norm="l2")
        out[fmt, "oracle", "single"] = japi.solve(JMATS[fmt], B1, method="oracle", tol=1e-8)
    return out


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("method, rhs", [("cg", "single"), ("cg", "block"), ("oracle", "single")])
def test_solve_matches_jax(jax_solves, fmt, method, rhs):
    b = B1 if rhs == "single" else BK
    res = api.solve(TMATS[fmt], b, method=method, tol=1e-8, norm="l2", device="cpu")
    ref = jax_solves[fmt, method, rhs]
    its, ref_its = np.asarray(res.iterations), np.asarray(ref.iterations)
    np.testing.assert_array_equal(its, ref_its)
    x = res.x.numpy() if torch.is_tensor(res.x) else res.x
    assert np.abs(x - np.asarray(ref.x)).max() <= X_TOL
    assert np.all(np.asarray(res.converged))
    if rhs == "block":  # column 0 is the single-RHS solve
        single = api.solve(TMATS[fmt], B1, tol=1e-8, norm="l2", device="cpu")
        assert int(its[0]) == single.iterations


@pytest.mark.parametrize("fmt", ["csr", "ell", "coo", "bsr", "dense"])
def test_host_container_placed_on_b_device(fmt):
    A = TMATS[fmt]
    assert tfmt.is_host(A)
    b = torch.from_numpy(B1)
    res = cg_solve(A, b)
    ref = cg_solve(A.device_put(device="cpu"), b)
    assert res.iterations == ref.iterations and torch.equal(res.x, ref.x)
    resk = cg_solve_multi(A, torch.from_numpy(BK))
    assert int(resk.iterations[0]) == res.iterations
    # fp32 through the facade: the container is cast with b
    r32 = api.solve(A, B1, dtype=np.float32, tol=1e-5, norm="rel_l2", device="cpu")
    assert r32.x.dtype == torch.float32 and r32.converged


def test_refined_and_mgcg_keep_their_dia_requirement():
    for method in ("refined", "mgcg"):
        with pytest.raises(TypeError, match="DiaMatrix"):
            api.solve(TMATS["csr"], B1, method=method, grid=(16, 16), device="cpu")
        with pytest.raises(TypeError, match="DiaMatrix"):
            api.solve(TMATS["csr"], BK, method=method, grid=(16, 16), device="cpu")


def test_direct_solve_and_facade_helpers_match_jax():
    for fmt in ("dia", "csr", "dense"):
        np.testing.assert_allclose(toracle.direct_solve(TMATS[fmt], B1),
                                   joracle.direct_solve(JMATS[fmt], B1), rtol=0, atol=1e-12)
    with pytest.raises(TypeError, match="unsupported"):
        toracle.direct_solve(TMATS["ell"], B1)
    for fmt in FORMATS:
        np.testing.assert_array_equal(api._diagonal(TMATS[fmt]), japi._diagonal(JMATS[fmt]))
        t, j = api._to_csr(TMATS[fmt]), japi._to_csr(JMATS[fmt])
        np.testing.assert_array_equal(t.data, np.asarray(j.data))
        np.testing.assert_array_equal(t.indices, np.asarray(j.indices))


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_kernel_operator_matches_pallas_interpret(fmt):
    A = tgen.banded_sin_matrix(700, 16)
    tc = tfmt.dia_to_csr(A)
    tA = tc if fmt == "csr" else tfmt.csr_to_ell(tc)
    jc = jfmt.dia_to_csr(jgen.banded_sin_matrix(700, 16))
    jA = jc if fmt == "csr" else jfmt.csr_to_ell(jc)
    x = np.random.default_rng(4).standard_normal(700)
    ref = np.asarray(make_pallas_operator(jA, interpret=True)(jnp.asarray(x)))
    cuda_dia.reset_launch_counts()
    op = make_kernel_operator(tA, device="cpu")
    y = op(torch.from_numpy(x))
    assert _rel(y.numpy(), ref) <= REL_PRODUCT and _rel(y.numpy(), toracle.spmv(A, x)) <= REL_PRODUCT
    # the relayout is the JAX package's csr_to_dia: every present diagonal
    assert op.args[0].offsets == jfmt.csr_to_dia(jc).offsets
    one_call = (spmv_csr_kernel if fmt == "csr" else spmv_ell_kernel)(tA, torch.from_numpy(x))
    assert torch.equal(one_call, y)
    # from tensors on the CPU, and cast on the way
    y32 = make_kernel_operator(tA.device_put(np.float32, device="cpu"), device="cpu")(
        torch.from_numpy(x.astype(np.float32)))
    assert y32.dtype == torch.float32 and _rel(y32.numpy(), ref) <= 1e-5
    assert spmv_dia_cuda.launches == 0  # the CPU runs the twin
    # through cg_solve: the relaid-out operator as a callable
    b = torch.from_numpy(tgen.banded_sin_system(700, 16).b)
    res, ref_res = cg_solve(op, b), cg_solve(tA, b)
    assert res.iterations == ref_res.iterations
    assert float((res.x - ref_res.x).abs().max()) <= X_TOL
    with pytest.raises(TypeError, match="relayout"):
        make_kernel_operator(tfmt.csr_to_coo(tc))


#: the spread of plain fp64 CG's true residual when only the products'
#: summation order differs (3.2x at 4096 rows between the port's CSR route
#: and the JAX package's; chip_smoke.py holds the card's routes to it)
CG_ORDER_SPREAD = 4.0


def test_plain_fp64_cg_stalls_at_the_jax_packages_attainable_accuracy():
    import scipy.sparse.linalg as sla

    from conjugategradient_tpu_torch.core.io import to_scipy

    n, band, tol, min_it = 4096, 160, 1e-8, 200  # the flagship's policy, cut to 4096 rows
    s = tgen.banded_sin_system(n, band, "cos10", "i/100")
    js = jgen.banded_sin_system(n, band, "cos10", "i/100")
    true_l2 = lambda x: float(np.linalg.norm(s.b - toracle.spmv(s.A, np.asarray(x, np.float64))))
    kw = dict(method="cg", tol=tol, norm="l2", min_iteration=min_it)
    jres = japi.solve(js.A, jnp.asarray(js.b), jnp.asarray(js.x0), **kw)
    csr = tfmt.dia_to_csr(s.A)
    tres = api.solve(csr, s.b, s.x0, device="cpu", **kw)
    assert int(jres.iterations) == int(tres.iterations) == min_it
    try:
        sx, info = sla.cg(to_scipy(csr), s.b, x0=s.x0, rtol=0.0, atol=0.0, maxiter=min_it)
    except TypeError:  # scipy < 1.12 names rtol tol
        sx, info = sla.cg(to_scipy(csr), s.b, x0=s.x0, tol=0.0, atol=0.0, maxiter=min_it)
    r_jax, r_scipy, r_port = true_l2(jres.x), true_l2(sx), true_l2(tres.x)
    # the recursive residual passed the policy long before; the true one
    # stalls orders of magnitude above it, in every implementation
    assert float(jres.residual) < 1e-6 * tol and float(tres.residual) < 1e-6 * tol
    assert min(r_jax, r_scipy, r_port) > 1e6 * max(float(jres.residual), float(tres.residual))
    # scipy's textbook CG stands in for the JAX package's
    assert 0.5 <= r_scipy / r_jax <= 2.0
    # the port reaches the JAX package's attainable accuracy up to the
    # summation-order spread
    assert r_port <= CG_ORDER_SPREAD * r_jax and r_jax <= CG_ORDER_SPREAD * r_port


def _stencil_dia(g: int, h: int, seed: int) -> tfmt.DiaMatrix:
    """A random (2h+1)^3-leg stencil on g^3 as flat DIA: the shape of a
    Galerkin level of a DIA-layout hierarchy (128^3 gives 16^3 x 343)."""
    n = g ** 3
    offs = sorted({(a * g + b) * g + c for a in range(-h, h + 1) for b in range(-h, h + 1)
                   for c in range(-h, h + 1)})
    data = np.random.default_rng(seed).standard_normal((len(offs), n))
    i = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    return tfmt.DiaMatrix(data, tuple(offs), (n, n))


def _chained(A: tfmt.DiaMatrix, X: np.ndarray) -> np.ndarray:
    """Kernels #4 and #5 past 256 diagonals, launch by launch in numpy: each
    group of ``dia_groups`` a launch; a launch after the first starts each
    row's sum from the Y the previous one wrote (accumulate = 1) and adds
    its legs one by one in ``A.offsets`` order, as a thread does."""
    Y = np.empty_like(X)
    for g, (k0, k1) in enumerate(dia_groups(A.ndiags)):
        acc = Y.copy() if g > 0 else np.zeros_like(X)
        for k in range(k0, k1):
            off = A.offsets[k]
            i0, i1 = max(0, -off), min(A.n, A.n - off)
            acc[:, i0:i1] += A.data[k, i0:i1] * X[:, i0 + off : i1 + off]
        Y = acc
    return Y


def test_dia_groups_plan():
    assert dia_groups(159) == [(0, 159)]
    assert dia_groups(256) == [(0, 256)]
    assert dia_groups(257) == [(0, 256), (256, 257)]
    assert dia_groups(343) == [(0, 256), (256, 343)]
    assert dia_groups(1331) == [(k, min(k + 256, 1331)) for k in range(0, 1331, 256)]
    assert len(dia_groups(1331)) == 6
    # a chained SpMM takes at most 4 columns a launch
    band = lambda nd: tfmt.DiaMatrix(np.zeros((nd, 400)), tuple(range(-(nd // 2), nd - nd // 2)),
                                     (400, 400))
    assert cuda_dia.spmm_chunks(band(159), 13) == [8, 4, 1]
    assert cuda_dia.spmm_chunks(band(256), 8) == [8]
    assert cuda_dia.spmm_chunks(band(343), 8) == [4, 4]
    assert cuda_dia.spmm_chunks(band(343), 13) == [4, 4, 4, 1]


@pytest.mark.parametrize("g, h", [(16, 3), (12, 5)])
def test_chained_plan_emulated_against_twin(g, h):
    A = _stencil_dia(g, h, seed=h)
    assert A.ndiags == (2 * h + 1) ** 3 > cuda_dia.MAX_DIAGS
    X = np.random.default_rng(g).standard_normal((3, A.n))
    Ad = A.device_put(device="cpu")
    emu = _chained(A, X)
    ref = spmm_dia_ref(Ad, torch.from_numpy(X)).numpy()
    assert _rel(emu, ref) <= 1e-12
    # the same legs in the same order: the twin's numbers exactly
    np.testing.assert_array_equal(emu, ref)
    np.testing.assert_array_equal(emu[0], spmv_dia_ref(Ad, torch.from_numpy(X[0])).numpy())
    # the fused p.Ap of the last group's launch is the dot of the whole y
    y, dot = spmv_dot_dia_cuda(Ad, torch.from_numpy(X[1]))
    np.testing.assert_array_equal(y.numpy(), emu[1])
    assert abs(float(dot) - float(X[1] @ emu[1])) <= 1e-12 * float(np.abs(X[1] * emu[1]).sum())
    # on the CPU the wrappers take the twins: any number of diagonals, no launch
    cuda_dia.reset_launch_counts()
    assert torch.equal(spmv_dia_cuda(Ad, torch.from_numpy(X[0])), torch.from_numpy(ref[0]))
    assert torch.equal(spmm_dia_cuda(Ad, torch.from_numpy(X)), torch.from_numpy(ref))
    assert spmv_dia_cuda.launches == spmm_dia_cuda.launches == 0
