"""The port's storage formats (``core/formats.py``, ``core/builder.py``)
against the JAX package's, on the CPU.

Every container and conversion is a numpy copy of the JAX package's, so each
result must be bit-identical: the same container type, the same arrays with
the same dtypes, the same static fields.  The inputs are made from numpy
seeds at small sizes.  ``convert.matrix_from_reference`` carries each JAX
container across by its fields, and ``to_sparse_coo`` / ``from_sparse_coo``
hand matrices to and from PyTorch's own sparse tensors.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import builder as jbuilder
from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu_torch.convert import matrix_from_reference
from conjugategradient_tpu_torch.core import builder as tbuilder
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen


def _same(t, j):
    """``t`` (port) and ``j`` (JAX) hold the same container: class name,
    arrays bit for bit with their dtypes, static fields."""
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(t):
        vt, vj = getattr(t, f.name), getattr(j, f.name)
        if isinstance(vt, np.ndarray):
            vj = np.asarray(vj)
            assert vt.dtype == vj.dtype and vt.shape == vj.shape, f.name
            np.testing.assert_array_equal(vt, vj, err_msg=f.name)
        else:
            assert vt == vj, f.name


def _scipy_pair(shape, density, seed, diag=True):
    """(port CSR, JAX CSR) of one seeded scipy matrix (canonical CSR)."""
    m = sp.random(*shape, density=density, random_state=seed, format="csr")
    if diag:
        m = (m + sp.eye(*shape, format="csr")).tocsr()
    m.sort_indices()
    parts = (m.data, m.indices, m.indptr, shape)
    return tfmt.csr_from_parts(*parts), jfmt.csr_from_parts(*parts)


SHAPES = [(64, 64), (40, 72), (72, 40)]


@pytest.mark.parametrize("shape", SHAPES)
def test_csr_conversions_bit_identical(shape):
    tc, jc = _scipy_pair(shape, 0.08, 3, diag=shape[0] == shape[1])
    _same(tc, jc)
    _same(tfmt.csr_to_coo(tc), jfmt.csr_to_coo(jc))
    _same(tfmt.coo_to_csr(tfmt.csr_to_coo(tc)), jfmt.coo_to_csr(jfmt.csr_to_coo(jc)))
    _same(tfmt.csr_to_dense(tc), jfmt.csr_to_dense(jc))
    _same(tfmt.dense_to_csr(tfmt.csr_to_dense(tc), tol=0.3), jfmt.dense_to_csr(jfmt.csr_to_dense(jc), tol=0.3))
    for k in (None, 12):
        _same(tfmt.csr_to_ell(tc, k), jfmt.csr_to_ell(jc, k))
    _same(tfmt.ell_to_csr(tfmt.csr_to_ell(tc)), jfmt.ell_to_csr(jfmt.csr_to_ell(jc)))
    with pytest.raises(ValueError, match="exceeds ELL width"):
        tfmt.csr_to_ell(tc, k=1)
    _same(tfmt.csr_to_bsr(tc, (8, 8)), jfmt.csr_to_bsr(jc, (8, 8)))
    _same(tfmt.csr_to_bsr(tc, (4, 8)), jfmt.csr_to_bsr(jc, (4, 8)))
    _same(tfmt.bsr_to_csr(tfmt.csr_to_bsr(tc, (8, 4))), jfmt.bsr_to_csr(jfmt.csr_to_bsr(jc, (8, 4))))
    with pytest.raises(ValueError, match="not divisible"):
        tfmt.csr_to_bsr(tc, (7, 8))
    _same(tfmt.transpose(tc), jfmt.transpose(jc))
    _same(tfmt.transpose(tfmt.csr_to_ell(tc)), jfmt.transpose(jfmt.csr_to_ell(jc)))
    _same(tfmt.transpose(tfmt.csr_to_coo(tc)), jfmt.transpose(jfmt.csr_to_coo(jc)))
    _same(tfmt.transpose(tfmt.csr_to_bsr(tc)), jfmt.transpose(jfmt.csr_to_bsr(jc)))
    _same(tfmt.transpose(tfmt.csr_to_dense(tc)), jfmt.transpose(jfmt.csr_to_dense(jc)))
    np.testing.assert_array_equal(tfmt.matrix_diagonal(tc), jfmt.matrix_diagonal(jc))
    if shape[0] == shape[1]:
        assert tfmt.is_symmetric(tc) == jfmt.is_symmetric(jc)


def test_coo_duplicates_summed_and_kept():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 30, 400).astype(np.int32)
    cols = rng.integers(0, 20, 400).astype(np.int32)
    data = rng.standard_normal(400)
    t, j = tfmt.CooMatrix(data, rows, cols, (30, 20)), jfmt.CooMatrix(data, rows, cols, (30, 20))
    for dup in (True, False):
        _same(tfmt.coo_to_csr(t, dup), jfmt.coo_to_csr(j, dup))
    empty = (np.zeros(0), np.zeros(0, np.int32), np.zeros(0, np.int32), (5, 5))
    _same(tfmt.coo_to_csr(tfmt.CooMatrix(*empty)), jfmt.coo_to_csr(jfmt.CooMatrix(*empty)))


@pytest.mark.parametrize("name", ["banded_sin_300_8", "poisson2d_9", "tridiag_50"])
def test_dia_conversions_bit_identical(name):
    make = {"banded_sin_300_8": lambda g: g.banded_sin_matrix(300, 8),
            "poisson2d_9": lambda g: g.poisson2d_matrix(9),
            "tridiag_50": lambda g: g.tridiagonal_matrix(50)}[name]
    ta, ja = make(tgen), make(jgen)
    _same(ta, ja)
    assert ta.nnz == ja.nnz and ta.bandwidth == ja.bandwidth
    tc, jc = tfmt.dia_to_csr(ta), jfmt.dia_to_csr(ja)
    _same(tc, jc)
    _same(tfmt.csr_to_dia(tc), jfmt.csr_to_dia(jc))
    wider = tuple(sorted(set(ta.offsets) | {-ta.n + 1, ta.n - 2}))
    _same(tfmt.csr_to_dia(tc, wider), jfmt.csr_to_dia(jc, wider))
    with pytest.raises(ValueError, match="outside the requested diagonal set"):
        tfmt.csr_to_dia(tc, ta.offsets[1:])
    _same(tfmt.dia_to_dense(ta), jfmt.dia_to_dense(ja))
    _same(tfmt.transpose(ta), jfmt.transpose(ja))
    np.testing.assert_array_equal(tfmt.matrix_diagonal(ta), jfmt.matrix_diagonal(ja))
    ts, js = tfmt.jacobi_scaled_dia(ta), jfmt.jacobi_scaled_dia(ja)
    _same(ts[0], js[0])
    np.testing.assert_array_equal(ts[1], js[1])
    assert tfmt.is_symmetric(ta) == jfmt.is_symmetric(ja)
    with pytest.raises(ValueError, match="square"):
        tfmt.csr_to_dia(tfmt.csr_from_parts(np.ones(1), [0], [0, 1, 1], (2, 3)))


@pytest.mark.parametrize("offsets", [(5, -3, 0, 2, -7), (1, 0, 1), ()])
def test_dia_to_csr_any_offsets_bit_identical(offsets):
    # unsorted offsets with stored zeros take the one-pass route, a repeated
    # offset the summing one: both give the JAX package's arrays
    data = np.random.default_rng(len(offsets)).standard_normal((len(offsets), 40))
    data[data < 0.3] = 0.0
    for dt in (np.float64, np.float32):
        t = tfmt.DiaMatrix(data.astype(dt), offsets, (40, 40))
        _same(tfmt.dia_to_csr(t), jfmt.dia_to_csr(jfmt.DiaMatrix(data.astype(dt), offsets, (40, 40))))


@pytest.mark.parametrize("grid", [(9, 7), (5, 4, 6)])
def test_stencil_conversions_bit_identical(grid):
    ta, ja = tgen.poisson_system(grid).A, jgen.poisson_system(grid).A
    tst, jst = tfmt.dia_to_stencil(ta, grid), jfmt.dia_to_stencil(ja, grid)
    _same(tfmt.stencil_to_dia(tst), jfmt.stencil_to_dia(jst))
    tcs, jcs = tfmt.stencil_to_const(tst), jfmt.stencil_to_const(jst)
    _same(tfmt.const_to_stencil(tcs), jfmt.const_to_stencil(jcs))
    for t, j in ((tst, jst), (tcs, jcs)):
        _same(tfmt._any_to_csr(t), jfmt._any_to_csr(j))
        _same(tfmt.transpose(t), jfmt.transpose(j))
        np.testing.assert_array_equal(tfmt.matrix_diagonal(t), jfmt.matrix_diagonal(j))
    # a nonsymmetric variable stencil: legs that differ per point
    legs = np.random.default_rng(2).standard_normal(tst.data.shape)
    legs = np.where(tst.data != 0, legs, 0.0)
    tv, jv = tfmt.StencilMatrix(legs, tst.shifts, grid), jfmt.StencilMatrix(legs, jst.shifts, grid)
    _same(tfmt.transpose(tv), jfmt.transpose(jv))
    assert tfmt.is_symmetric(tv) is jfmt.is_symmetric(jv) is False
    assert tfmt.is_symmetric(tst) is jfmt.is_symmetric(jst) is True


def test_is_symmetric_tolerance():
    tc, jc = _scipy_pair((30, 30), 0.2, 5)
    t_sym = tfmt.coo_to_csr(tfmt.CooMatrix(
        np.concatenate([tc.data, tc.data]), np.concatenate([tc.row_ids, tc.indices]),
        np.concatenate([tc.indices, tc.row_ids]), tc.shape))
    assert tfmt.is_symmetric(t_sym)
    bumped = tfmt.CsrMatrix(t_sym.data + 1e-9 * (np.arange(t_sym.nnz) % 3), t_sym.indices,
                            t_sym.indptr, t_sym.row_ids, t_sym.shape)
    assert not tfmt.is_symmetric(bumped)
    assert tfmt.is_symmetric(bumped, tol=1e-8)
    assert tfmt.is_symmetric(tc) == jfmt.is_symmetric(jc) is False


def test_dok_builder_matches_both_jax_routes():
    rng = np.random.default_rng(11)
    tb, jb = tbuilder.DokBuilder(40, 30), jbuilder.DokBuilder(40, 30)
    for _ in range(300):
        i, j, v = int(rng.integers(40)), int(rng.integers(30)), float(rng.standard_normal())
        for b in (tb, jb):
            if v > 0.5:
                b.add(i, j, v)
            else:
                b[i, j] = v
    tb[0, 0] = 0.0  # an explicit zero on a missing key is not stored
    jb[0, 0] = 0.0
    assert len(tb) == len(jb) and tb[3, 4] == jb[3, 4]
    _same(tb.to_coo(), jb.to_coo())
    tcsr = tb.to_csr()
    # the JAX builder's route (its C++ kit where built, else coo_to_csr) and
    # the numpy route it falls back to give the same CSR as the port's
    _same(tcsr, jb.to_csr())
    _same(tcsr, jfmt.coo_to_csr(jb.to_coo()))
    with pytest.raises(IndexError):
        tb[40, 0] = 1.0


def test_matrix_from_reference_every_container():
    ja = jgen.banded_sin_matrix(96, 8)
    jc = jfmt.dia_to_csr(ja)
    jst = jfmt.dia_to_stencil(jgen.poisson_system((8, 12)).A, (8, 12))
    refs = [ja, jc, jfmt.csr_to_ell(jc), jfmt.csr_to_coo(jc), jfmt.csr_to_bsr(jc),
            jfmt.dia_to_dense(ja), jst, jfmt.stencil_to_const(jst)]
    for j in refs:
        _same(matrix_from_reference(j), j)
    # device (jnp) arrays read across too
    for j in (ja.device_put(), jc.device_put(np.float32), jfmt.csr_to_bsr(jc).device_put()):
        t = matrix_from_reference(j)
        for f in dataclasses.fields(t):
            v = getattr(t, f.name)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, np.asarray(getattr(j, f.name)))
    with pytest.raises(TypeError, match="no port container"):
        matrix_from_reference(object())


def test_device_put_astype_and_properties():
    tc, jc = _scipy_pair((64, 64), 0.1, 9)
    conts = [(tc, jc), (tfmt.csr_to_ell(tc), jfmt.csr_to_ell(jc)),
             (tfmt.csr_to_coo(tc), jfmt.csr_to_coo(jc)),
             (tfmt.csr_to_bsr(tc), jfmt.csr_to_bsr(jc)),
             (tfmt.csr_to_dense(tc), jfmt.csr_to_dense(jc))]
    for t, j in conts:
        assert t.n == j.n and t.shape == j.shape and t.dtype == j.dtype
        for attr in ("nnz", "k", "block_shape", "nblocks"):
            if hasattr(j, attr):
                assert getattr(t, attr) == getattr(j, attr), attr
        d = t.device_put(np.float32, "cpu")
        assert d.data.dtype == torch.float32 and d.shape == t.shape
        for f in dataclasses.fields(d):
            v = getattr(d, f.name)
            if torch.is_tensor(v) and f.name != "data":
                assert v.dtype == torch.int32 and v.is_contiguous()
        assert t.astype(np.float32).data.dtype == np.float32
        assert d.astype(torch.float64).data.dtype == torch.float64
        assert tfmt.is_host(t) and not tfmt.is_host(d)
        assert tfmt.to_host(d).data.dtype == np.float32
        if hasattr(j, "device_put"):  # JAX's COO has none
            jd = j.device_put(np.float32)
            np.testing.assert_array_equal(d.data.numpy(), np.asarray(jd.data))
    assert not tfmt.is_host(tfmt.stencil_to_const(tfmt.dia_to_stencil(tgen.poisson_system((5, 5)).A, (5, 5))))


@pytest.mark.parametrize("fmt", ["csr", "ell", "coo", "bsr", "dense", "dia"])
def test_sparse_coo_interchange(fmt):
    ta = tgen.banded_sin_matrix(64, 8)
    tc = tfmt.dia_to_csr(ta)
    A = {"csr": tc, "ell": tfmt.csr_to_ell(tc), "coo": tfmt.csr_to_coo(tc),
         "bsr": tfmt.csr_to_bsr(tc), "dense": tfmt.csr_to_dense(tc), "dia": ta}[fmt]
    m = tfmt.to_sparse_coo(A)
    assert m.is_sparse and m.is_coalesced() and tuple(m.shape) == A.shape
    np.testing.assert_array_equal(m.to_dense().numpy(), tfmt.csr_to_dense(tc).data)
    _same(tfmt.from_sparse_coo(m), tc)
    # an uncoalesced tensor: duplicates summed on the way in, as from_bcoo does
    idx = torch.tensor([[0, 1, 0], [2, 0, 2]])
    u = torch.sparse_coo_tensor(idx, torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), (2, 3),
                                check_invariants=True)
    back = tfmt.from_sparse_coo(u)
    np.testing.assert_array_equal(tfmt.csr_to_dense(back).data, [[0, 0, 4.0], [2.0, 0, 0]])
    j = jfmt.from_bcoo(jfmt.to_bcoo(jfmt.dia_to_csr(jgen.banded_sin_matrix(64, 8))))
    _same(tfmt.from_sparse_coo(m), j)


def test_any_to_csr_refuses_unknown():
    with pytest.raises(TypeError, match="cannot convert"):
        tfmt._any_to_csr(np.eye(3))
    assert jnp is not None
