"""The port's DIA kernel module (``ops/cuda_dia.py``) on the CPU.

The plain twins of kernels #4 (SpMV, fused p·Ap) and #5 (SpMM) are held to
the JAX package's column-major Pallas kernels run in interpret mode and to
its XLA ``spmv_dia``, on the same inputs made from a numpy seed.  On the CPU
the wrappers must take the twins and launch nothing; their kernel-path
argument checks run on ``meta`` tensors, which are neither the CPU nor CUDA.
The kernels themselves are compared with the twins on the card
(``chip_smoke.py``, ``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import oracle as joracle
from conjugategradient_tpu.core.formats import DiaMatrix as JDia
from conjugategradient_tpu.ops.pallas_spmv import (
    spmm_dia_pallas,
    spmv_dia_pallas,
    spmv_dot_dia_pallas,
)
from conjugategradient_tpu.ops.spmm import spmm_dia as j_spmm_dia
from conjugategradient_tpu.ops.spmv import spmv_dia as j_spmv_dia
from conjugategradient_tpu_torch.convert import dia_from_reference
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import cuda_dia
from conjugategradient_tpu_torch.ops.cuda_dia import (
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
    spmv_dot_dia_ref,
)
from conjugategradient_tpu_torch.ops.spmm import spmm
from conjugategradient_tpu_torch.ops.spmv import as_operator, spmv

#: fp32, legs summed in the same or a different order: a few ulps of the
#: largest partial sum
REL32 = 1e-6
#: fp64 against the fp64 oracle (same leg order, fp64 rounding)
REL64 = 1e-13

MATRICES = {
    "banded_700_16": lambda g: g.banded_sin_matrix(700, 16),
    "banded_333_8": lambda g: g.banded_sin_matrix(333, 8),
    "tridiag_1023": lambda g: g.tridiagonal_matrix(1023),
    "poisson2d_31": lambda g: g.poisson2d_matrix(31),
}


def _pair(name, dtype=np.float32):
    """(JAX DiaMatrix on the device, port DiaMatrix on the CPU) of one
    generator, in ``dtype``; the host data must be bit-identical."""
    jA, tA = MATRICES[name](jgen), MATRICES[name](tgen)
    assert jA.offsets == tA.offsets and np.array_equal(np.asarray(jA.data), tA.data)
    return jA.device_put(dtype), tA.device_put(dtype)


def _close(a, ref, rel):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert np.abs(a - ref).max() <= rel * np.abs(ref).max()


@pytest.mark.parametrize("name", list(MATRICES))
def test_spmv_twin_matches_pallas_interpret_and_xla(name):
    jA, tA = _pair(name)
    x = np.random.default_rng(0).standard_normal(tA.n).astype(np.float32)
    y_t = spmv_dia_ref(tA, torch.from_numpy(x)).numpy()
    assert y_t.dtype == np.float32
    _close(y_t, spmv_dia_pallas(jA, jnp.asarray(x), interpret=True), REL32)
    _close(y_t, j_spmv_dia(jA, jnp.asarray(x)), REL32)


@pytest.mark.parametrize("name", list(MATRICES))
def test_spmv_twin_fp64_matches_oracle(name):
    _, tA = _pair(name, np.float64)
    x = np.random.default_rng(1).standard_normal(tA.n)
    y = spmv_dia_ref(tA, torch.from_numpy(x)).numpy()
    _close(y, oracle.spmv(MATRICES[name](tgen), x), REL64)
    _close(y, joracle.spmv(MATRICES[name](jgen), x), REL64)


def test_twins_on_random_offsets():
    """Random DIA patterns (as ``test_cm_plan_fuzz_random_offsets``): ragged
    spans, offsets wider than n/2, with and without a main diagonal, more
    than one 32-diagonal group of the TPU kernel."""
    rng = np.random.default_rng(9)
    for trial in range(3):
        n = int(rng.integers(300, 1200))
        nd = int(rng.integers(1, 40))
        span = int(rng.integers(4, max(5, n // 2)))
        offs = np.sort(rng.choice(np.arange(-span, span + 1), size=nd, replace=False))
        if trial % 2 == 0 and 0 not in offs:
            offs[0] = 0
            offs = np.sort(offs)
        data = rng.standard_normal((len(offs), n)).astype(np.float32)
        for k, off in enumerate(offs):
            if off < 0:
                data[k, :-off] = 0.0
            elif off > 0:
                data[k, n - off:] = 0.0
        offsets = tuple(int(o) for o in offs)
        jA = JDia(data=data, offsets=offsets, shape=(n, n)).device_put()
        tA = dia_from_reference(jA).device_put()
        x = rng.standard_normal(n).astype(np.float32)
        X = rng.standard_normal((n, 3)).astype(np.float32)
        y_t = spmv_dia_ref(tA, torch.from_numpy(x)).numpy()
        _close(y_t, spmv_dia_pallas(jA, jnp.asarray(x), interpret=True), REL32)
        _close(y_t, j_spmv_dia(jA, jnp.asarray(x)), REL32)
        Y_t = spmm_dia_ref(tA, torch.from_numpy(X.T.copy())).numpy().T
        _close(Y_t, j_spmm_dia(jA, jnp.asarray(X)), REL32)


def test_fused_dot_twin_matches_pallas_interpret():
    jA, tA = _pair("banded_700_16")
    p = np.random.default_rng(2).standard_normal(tA.n).astype(np.float32)
    y_j, d_j = spmv_dot_dia_pallas(jA, jnp.asarray(p), interpret=True)
    y_t, d_t = spmv_dot_dia_ref(tA, torch.from_numpy(p))
    _close(y_t.numpy(), y_j, REL32)
    # fp32 sums of 700 products in two orders
    assert abs(float(d_t) - float(d_j)) <= 1e-5 * float(np.abs(p * y_t.numpy()).sum())


def test_bf16_legs_within_one_ulp_of_jax_and_accumulate_fp32():
    jA = MATRICES["banded_700_16"](jgen).device_put(jnp.bfloat16)
    tA = MATRICES["banded_700_16"](tgen).device_put(torch.bfloat16)
    assert tA.data.dtype == torch.bfloat16
    legs_j = np.asarray(jA.data).astype(np.float32)
    legs_t = tA.data.float().numpy()
    # one bf16 ulp: 2^-7 of the leading power of two (8 significant bits)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(legs_j), 1e-30))) - 7)
    assert np.all(np.abs(legs_t - legs_j) <= ulp)
    x = np.random.default_rng(3).standard_normal(tA.n).astype(np.float32)
    y_t = spmv_dia_ref(tA, torch.from_numpy(x))
    assert y_t.dtype == torch.float32
    # same legs in fp32 give the same sums: bf16 legs widen exactly
    jA_same = JDia(jnp.asarray(legs_t).astype(jnp.bfloat16), jA.offsets, jA.shape)
    _close(y_t.numpy(), spmv_dia_pallas(jA_same, jnp.asarray(x), interpret=True), REL32)


#: the twins past 256 diagonals against the JAX package's chained 32-leg
#: groups: fp32 at 2e-6 of max|ref| (the JAX package sums each group before
#: adding its y_in, the twin leg by leg: 5.98e-7 measured at this shape),
#: fp64 at 1e-12
REL32_MANY, REL64_MANY = 2e-6, 1e-12


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_twins_past_256_diagonals_match_pallas_interpret(dtype):
    """A random 10^3 stencil's 343 offsets (its 7^3 box folded flat), leg
    entries whose neighbour leaves [0, n) zero: kernel #4's twins against
    ``spmv_dia_pallas`` and ``spmv_dot_dia_pallas`` in interpret mode."""
    g, n = 10, 1000
    offs = sorted({(a * g + b) * g + c for a in range(-3, 4) for b in range(-3, 4)
                   for c in range(-3, 4)})
    assert len(offs) == 343 > cuda_dia.MAX_DIAGS
    rng = np.random.default_rng(11)
    data = rng.standard_normal((len(offs), n))
    i = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    jA = JDia(data=data, offsets=tuple(offs), shape=(n, n)).device_put(dtype)
    tA = dia_from_reference(jA).device_put(dtype, "cpu")
    p = rng.standard_normal(n).astype(dtype)
    rel = REL32_MANY if dtype == np.float32 else REL64_MANY
    y_t = spmv_dia_ref(tA, torch.from_numpy(p)).numpy()
    _close(y_t, spmv_dia_pallas(jA, jnp.asarray(p), interpret=True), rel)
    y_j, d_j = spmv_dot_dia_pallas(jA, jnp.asarray(p), interpret=True)
    y_f, d_t = spmv_dot_dia_ref(tA, torch.from_numpy(p))
    _close(y_f.numpy(), y_j, rel)
    assert abs(float(d_t) - float(d_j)) <= rel * float(np.abs(p * y_t).sum())


@pytest.mark.parametrize("k", [1, 3, 8])
def test_spmm_twin_matches_pallas_interpret(k):
    jA, tA = _pair("banded_700_16")
    X = np.random.default_rng(4).standard_normal((tA.n, k)).astype(np.float32)
    Y_j = spmm_dia_pallas(jA, jnp.asarray(X), interpret=True)
    Y_t = spmm(tA, torch.from_numpy(X))
    assert tuple(Y_t.shape) == (tA.n, k)
    _close(Y_t.numpy(), Y_j, REL32)
    # column j of the SpMM twin is the SpMV twin of column j, exactly
    for j in range(k):
        assert torch.equal(Y_t[:, j], spmv_dia_ref(tA, torch.from_numpy(X[:, j].copy())))


def test_cpu_wrappers_take_the_twins_and_launch_nothing():
    _, tA = _pair("banded_333_8")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(tA.n).astype(np.float32))
    cuda_dia.reset_launch_counts()
    assert torch.equal(spmv_dia_cuda(tA, x), spmv_dia_ref(tA, x))
    assert torch.equal(as_operator(tA)(x), spmv(tA, x))
    y, d = spmv_dot_dia_cuda(tA, x)
    assert torch.equal(y, spmv_dia_ref(tA, x)) and torch.equal(d, spmv_dot_dia_ref(tA, x)[1])
    X = torch.stack([x, 2 * x])
    assert torch.equal(spmm_dia_cuda(tA, X), spmm_dia_ref(tA, X))
    for fn in (spmv_dia_cuda, spmv_dot_dia_cuda, spmm_dia_cuda):
        assert fn.launches == 0 and not fn.launches_by_dtype


def test_host_dia_operator_is_placed_on_the_cpu():
    A = tgen.tridiagonal_matrix(50)
    x = np.linspace(-1.0, 1.0, 50)
    y = as_operator(A)(torch.from_numpy(x))
    np.testing.assert_array_equal(y.numpy(), oracle.spmv(A, x))


def test_k_chunks():
    assert cuda_dia.k_chunks(1) == [1]
    assert cuda_dia.k_chunks(3) == [2, 1]
    assert cuda_dia.k_chunks(8) == [8]
    assert cuda_dia.k_chunks(13) == [8, 4, 1]
    assert cuda_dia.k_chunks(0) == []


def _meta(A, legs):
    return A.device_put(legs, "meta")


def test_kernel_path_checks_raise_instead_of_falling_back():
    A = tgen.banded_sin_matrix(333, 8)
    meta32 = _meta(A, torch.float32)
    x = torch.empty(333, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_dia_cuda(meta32, x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_dot_dia_cuda(_meta(A, torch.bfloat16), x)
    with pytest.raises(TypeError, match="no kernel"):
        spmv_dia_cuda(meta32, torch.empty(333, dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError, match="no kernel"):
        spmv_dia_cuda(_meta(A, torch.float16), x)
    with pytest.raises(ValueError, match="not \\(n,\\)"):
        spmv_dia_cuda(meta32, torch.empty(332, device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dia_cuda(meta32, torch.empty((333, 2), device="meta").T)
    # kernel #5 takes fp64 legs with fp64 columns: refused only for the device
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_dia_cuda(_meta(A, torch.float64), torch.empty((2, 333), dtype=torch.float64,
                                                           device="meta"))
    with pytest.raises(TypeError, match="device_put"):
        spmv_dia_cuda(A, x)
    # more than 256 diagonals pass the count check (chained launches) and
    # stop at the device check; none at all, or more than 256 for kernel #6,
    # stop at the count
    wide = DiaMatrix(np.zeros((300, 400), np.float32), tuple(range(-150, 150)), (400, 400))
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmv_dia_cuda(_meta(wide, torch.float32), torch.empty(400, device="meta"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_dia_cuda(_meta(wide, torch.float32), torch.empty((2, 400), device="meta"))
    with pytest.raises(ValueError, match="1..256 diagonals"):
        cuda_dia.spmm_dia_acc_cuda(_meta(wide, torch.float32), torch.empty((2, 400), device="meta"))
    empty = DiaMatrix(np.zeros((0, 400), np.float32), (), (400, 400))
    with pytest.raises(ValueError, match="1 diagonals supported, got 0"):
        spmv_dia_cuda(_meta(empty, torch.float32), torch.empty(400, device="meta"))
    with pytest.raises(TypeError, match="DiaMatrix"):
        spmv_dia_cuda(object(), x)


def test_device_put_and_bandwidth():
    A = tgen.banded_sin_matrix(64, 160 // 10)
    assert A.bandwidth == 7 == MATRICES["banded_700_16"](jgen).bandwidth
    P = A.device_put()
    assert P.data.dtype == torch.float64 and np.shares_memory(P.data.numpy(), A.data)
    assert A.device_put(np.float32).data.dtype == torch.float32
    assert P.device_put(torch.bfloat16).data.dtype == torch.bfloat16
    assert P.offsets == A.offsets and P.shape == A.shape


def test_unsupported_types_raise_type_error():
    from conjugategradient_tpu_torch.core.formats import StencilMatrix

    st = StencilMatrix(np.ones((1, 4, 4)), ((0, 0),), (4, 4))
    # the variable-coefficient stencil SpMV runs (kernel #3); the spmm
    # dispatch takes no grid stencil and a bare array is no operator, each a
    # TypeError as in the JAX package's dispatch
    assert torch.equal(as_operator(st)(torch.arange(16.0, dtype=torch.float64)),
                       torch.arange(16.0, dtype=torch.float64))
    with pytest.raises(TypeError, match="unsupported matrix type"):
        spmm(st, torch.zeros((16, 2)))
    with pytest.raises(TypeError, match="unsupported matrix type"):
        as_operator(np.zeros((4, 4)))
