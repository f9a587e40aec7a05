"""Matrix ingestion: Matrix Market files and scipy.sparse interop.

The counterpart of ``conjugategradient_tpu/core/io.py``:

- **Matrix Market** (``.mtx``): ``load_matrix_market`` /
  ``save_matrix_market``.  Loading picks the storage: a matrix whose
  nonzeros sit on few distinct diagonals (within a storage-blowup budget)
  lands in DIA, the format kernel #4 runs, anything else in CSR.
- **scipy.sparse**: ``from_scipy`` / ``to_scipy``.

Host-side (file IO and format analysis are setup work); the returned
containers ``device_put`` like any other.
"""

from __future__ import annotations

import numpy as np

from conjugategradient_tpu_torch.core.formats import (
    CooMatrix,
    CsrMatrix,
    _any_to_csr,
    coo_to_csr,
    csr_from_parts,
    csr_to_dia,
)


def from_scipy(m) -> CsrMatrix:
    """Any ``scipy.sparse`` matrix -> ``CsrMatrix`` (duplicates summed).

    A CSR input reuses ``indptr``/``indices``/``data`` (copied, so the
    container never aliases the caller's matrix; canonicalised on a copy
    when scipy has not) instead of a round trip through COO and a lexsort."""
    import scipy.sparse as sp

    if sp.issparse(m) and m.format == "csr":
        if not m.has_canonical_format:
            m = m.copy()
            m.sum_duplicates()
        return csr_from_parts(np.array(m.data), np.array(m.indices), np.array(m.indptr),
                              tuple(m.shape))
    coo = m.tocoo()
    return coo_to_csr(CooMatrix(data=np.asarray(coo.data), rows=np.asarray(coo.row, np.int32),
                                cols=np.asarray(coo.col, np.int32), shape=tuple(coo.shape)))


def to_scipy(A):
    """Any container -> ``scipy.sparse.csr_matrix``."""
    import scipy.sparse as sp

    csr = A if isinstance(A, CsrMatrix) else _any_to_csr(A)
    return sp.csr_matrix(
        (np.asarray(csr.data), np.asarray(csr.indices), np.asarray(csr.indptr)), shape=csr.shape
    )


def load_matrix_market(path, prefer: str = "auto", max_blowup: float = 3.0):
    """Read a Matrix Market file into the right container.

    ``prefer``: ``"auto"`` (DIA when the diagonal-storage blowup
    ``n_diags * n / nnz`` stays within ``max_blowup``, else CSR), ``"csr"``,
    or ``"dia"`` (the blowup guard ignored).  A non-square matrix is CSR.
    Symmetric, skew and hermitian storage is expanded by scipy on read, so
    the container holds the full matrix."""
    from scipy.io import mmread

    csr = from_scipy(mmread(str(path)))
    if prefer == "csr":
        return csr
    n, mcols = csr.shape
    if n != mcols:
        return csr
    diags = np.unique(np.asarray(csr.indices, np.int64) - np.asarray(csr.row_ids, np.int64))
    if prefer == "dia" or len(diags) * n <= max_blowup * max(csr.nnz, 1):
        return csr_to_dia(csr, offsets=tuple(int(o) for o in diags))
    return csr


def save_matrix_market(path, A, comment: str = "") -> None:
    """Write any container as a Matrix Market coordinate file."""
    from scipy.io import mmwrite

    mmwrite(str(path), to_scipy(A).tocoo(), comment=comment)


def load_vector_market(path) -> np.ndarray:
    """Read a Matrix Market dense array file as a flat (n,) vector."""
    from scipy.io import mmread

    return np.asarray(mmread(str(path))).reshape(-1)


def save_vector_market(path, v, comment: str = "") -> None:
    from scipy.io import mmwrite

    mmwrite(str(path), np.asarray(v).reshape(-1, 1), comment=comment)
