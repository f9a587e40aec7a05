"""DOK (dictionary-of-keys) matrix builder.

The counterpart of ``conjugategradient_tpu/core/builder.py``: the
reference's auto-growing DOK container
(``Mgcg/ViennaCL/MgcgCL/CompressedMatrix.cs:8-69``), flattened to CSR
through numpy triplets (``core.formats.coo_to_csr``).  The JAX package
prefers its C++ kit's ``coo_to_csr`` where it is built; both give the same
CSR arrays.
"""

from __future__ import annotations

import numpy as np

from conjugategradient_tpu_torch.core.formats import CooMatrix, CsrMatrix, coo_to_csr


class DokBuilder:
    """Incrementally build a sparse matrix by (row, col) assignment.

    >>> b = DokBuilder(3)
    >>> b[0, 0] = 2.0
    >>> b[0, 1] += 1.0   # missing entries read as 0.0, like the reference
    >>> A = b.to_csr()
    """

    def __init__(self, n: int, m: int | None = None, dtype=np.float64):
        self.n = int(n)
        self.m = int(m) if m is not None else int(n)
        self.dtype = np.dtype(dtype)
        self._entries: dict[tuple[int, int], float] = {}

    def __len__(self) -> int:
        return len(self._entries)

    def _check(self, key):
        i, j = key
        i, j = int(i), int(j)
        if not (0 <= i < self.n and 0 <= j < self.m):
            raise IndexError(f"({i}, {j}) out of bounds for {self.n}x{self.m}")
        return i, j

    def __getitem__(self, key) -> float:
        return self._entries.get(self._check(key), 0.0)

    def __setitem__(self, key, value) -> None:
        i, j = self._check(key)
        if value == 0.0 and (i, j) not in self._entries:
            return
        self._entries[(i, j)] = float(value)

    def add(self, i: int, j: int, value: float) -> None:
        i, j = self._check((i, j))
        self._entries[(i, j)] = self._entries.get((i, j), 0.0) + float(value)

    def to_coo(self) -> CooMatrix:
        nnz = len(self._entries)
        rows = np.empty(nnz, dtype=np.int32)
        cols = np.empty(nnz, dtype=np.int32)
        data = np.empty(nnz, dtype=self.dtype)
        for idx, ((i, j), v) in enumerate(self._entries.items()):
            rows[idx], cols[idx], data[idx] = i, j, v
        return CooMatrix(data, rows, cols, (self.n, self.m))

    def to_csr(self) -> CsrMatrix:
        return coo_to_csr(self.to_coo())
