"""Sparsity visualisation: the R prototype's ``image()`` spy plot
(``R/CG.R:29-32``), terminal-native.

``spy(A)`` renders an ASCII density map of any storage format of
``core.formats`` (each character cell aggregates a block of the matrix;
darker = denser), and ``spy_counts`` returns the raw density grid.
"""

from __future__ import annotations

import numpy as np

from conjugategradient_tpu_torch.core.formats import _any_to_csr, to_host

_RAMP = " .:-=+*#%@"


def spy_counts(A, cells: int = 48) -> np.ndarray:
    """(r, c) grid of nnz counts, aggregating the matrix into at most
    ``cells`` x ``cells`` blocks; a device container is read back first."""
    csr = _any_to_csr(to_host(A))
    n, m = csr.shape
    r = min(cells, n)
    c = min(cells, m)
    rows = (np.asarray(csr.row_ids, dtype=np.int64) * r) // max(n, 1)
    cols = (np.asarray(csr.indices, dtype=np.int64) * c) // max(m, 1)
    grid = np.zeros((r, c), dtype=np.int64)
    mask = np.asarray(csr.data) != 0
    np.add.at(grid, (rows[mask], cols[mask]), 1)
    return grid


def spy(A, cells: int = 48) -> str:
    """ASCII spy plot; returns the string (print it)."""
    grid = spy_counts(A, cells)
    peak = grid.max()
    if peak == 0:
        return "(empty matrix)"
    lines = []
    for row in grid:
        idx = (row * (len(_RAMP) - 1)) // peak
        lines.append("".join(_RAMP[i] for i in idx))
    n, m = getattr(A, "shape", ("?", "?"))
    lines.append(f"[{n} x {m}, {int((grid > 0).sum())}/{grid.size} blocks occupied]")
    return "\n".join(lines)
