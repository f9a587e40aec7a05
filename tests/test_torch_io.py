"""Matrix Market and scipy ingestion of the port (``core/io.py``) against the
JAX package's ``core/io.py``, on the CPU.

Files go through ``tmp_path``.  A banded matrix lands in DIA, an irregular
one in CSR, a symmetric-storage file is expanded to the full matrix, and the
port's loader gives the same container type and the same arrays as the JAX
package's on the same file, whichever package wrote it.
"""

import dataclasses

import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import io as jio
from conjugategradient_tpu_torch.core import formats as tfmt
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import io as tio


def _same(t, j):
    assert type(t).__name__ == type(j).__name__
    for f in dataclasses.fields(t):
        vt, vj = getattr(t, f.name), getattr(j, f.name)
        if isinstance(vt, np.ndarray):
            vj = np.asarray(vj)
            assert vt.dtype == vj.dtype, f.name
            np.testing.assert_array_equal(vt, vj, err_msg=f.name)
        else:
            assert vt == vj, f.name


def _irregular(n=120, seed=4):
    """A symmetric matrix whose entries sit on many diagonals."""
    m = sp.random(n, n, density=0.05, random_state=seed, format="csr")
    return (m + m.T + sp.eye(n) * n).tocsr()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_banded_file_lands_in_dia(tmp_path, writer):
    path = tmp_path / "banded.mtx"
    if writer == "port":
        tio.save_matrix_market(path, tgen.banded_sin_matrix(300, 8), comment="banded")
    else:
        jio.save_matrix_market(path, jgen.banded_sin_matrix(300, 8), comment="banded")
    t, j = tio.load_matrix_market(path), jio.load_matrix_market(path)
    assert isinstance(t, tfmt.DiaMatrix)
    _same(t, j)
    _same(tio.load_matrix_market(path, prefer="csr"), jio.load_matrix_market(path, prefer="csr"))
    # the same nonzeros as the generator's matrix (its explicit zeros dropped)
    _same(tfmt.dia_to_csr(t), tfmt.dia_to_csr(tgen.banded_sin_matrix(300, 8)))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_irregular_file_lands_in_csr(tmp_path, writer):
    m = _irregular()
    path = tmp_path / "irregular.mtx"
    (tio if writer == "port" else jio).save_matrix_market(path, (tio if writer == "port" else jio).from_scipy(m))
    t, j = tio.load_matrix_market(path), jio.load_matrix_market(path)
    assert isinstance(t, tfmt.CsrMatrix)
    _same(t, j)
    # the blowup guard: with room enough it lands in DIA, or on request
    _same(tio.load_matrix_market(path, max_blowup=1e9), jio.load_matrix_market(path, max_blowup=1e9))
    _same(tio.load_matrix_market(path, prefer="dia"), jio.load_matrix_market(path, prefer="dia"))
    assert isinstance(tio.load_matrix_market(path, prefer="dia"), tfmt.DiaMatrix)
    np.testing.assert_array_equal(tfmt.csr_to_dense(t).data, m.toarray())


def test_symmetric_storage_is_expanded(tmp_path):
    m = _irregular(80, 6)
    path = tmp_path / "sym.mtx"
    scipy.io.mmwrite(str(path), sp.tril(m).tocoo(), symmetry="symmetric")
    assert "symmetric" in path.read_text().splitlines()[0]
    t, j = tio.load_matrix_market(path), jio.load_matrix_market(path)
    _same(t, j)
    np.testing.assert_array_equal(tfmt.csr_to_dense(tfmt._any_to_csr(t)).data, m.toarray())
    assert tfmt.is_symmetric(t)


def test_rectangular_file_stays_csr(tmp_path):
    m = sp.random(30, 50, density=0.1, random_state=2, format="csr")
    path = tmp_path / "rect.mtx"
    tio.save_matrix_market(path, tio.from_scipy(m))
    for prefer in ("auto", "dia"):
        t, j = tio.load_matrix_market(path, prefer=prefer), jio.load_matrix_market(path, prefer=prefer)
        assert isinstance(t, tfmt.CsrMatrix)
        _same(t, j)


def test_scipy_interop():
    m = _irregular(60, 8)
    _same(tio.from_scipy(m), jio.from_scipy(m))
    _same(tio.from_scipy(m.tocoo()), jio.from_scipy(m.tocoo()))
    # a non-canonical CSR (unsorted, duplicates): summed on a copy
    dup = sp.csr_matrix((np.array([1.0, 2.0, 3.0]), np.array([2, 0, 2]), np.array([0, 3, 3])),
                        shape=(2, 3))
    t = tio.from_scipy(dup)
    _same(t, jio.from_scipy(dup))
    assert dup.nnz == 3 and t.nnz == 2
    np.testing.assert_array_equal(tfmt.csr_to_dense(t).data, [[2.0, 0.0, 4.0], [0.0, 0.0, 0.0]])
    # the container never aliases the caller's matrix
    t = tio.from_scipy(m)
    t.data[0] += 1.0
    assert t.data[0] != m.data[0]
    assert (tio.to_scipy(tgen.banded_sin_matrix(64, 8))
            != jio.to_scipy(jgen.banded_sin_matrix(64, 8))).nnz == 0
    ell_t, ell_j = tfmt.csr_to_ell(tio.from_scipy(m)), jfmt.csr_to_ell(jio.from_scipy(m))
    assert (tio.to_scipy(ell_t) != jio.to_scipy(ell_j)).nnz == 0


def test_vector_market_round_trip(tmp_path):
    v = np.random.default_rng(3).standard_normal(77)
    tio.save_vector_market(tmp_path / "v.mtx", v, comment="rhs")
    np.testing.assert_array_equal(tio.load_vector_market(tmp_path / "v.mtx"), v)
    np.testing.assert_array_equal(jio.load_vector_market(tmp_path / "v.mtx"), v)
    jio.save_vector_market(tmp_path / "w.mtx", v)
    np.testing.assert_array_equal(tio.load_vector_market(tmp_path / "w.mtx"), v)
