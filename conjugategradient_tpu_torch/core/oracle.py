"""fp64 numpy oracle SpMV: the ground truth for true-residual checks."""

from __future__ import annotations

import numpy as np

from conjugategradient_tpu_torch.core.formats import DiaMatrix


def spmv(A, x: np.ndarray) -> np.ndarray:
    """y = A x for a host ``DiaMatrix``, in the promoted dtype of A and x."""
    if not isinstance(A, DiaMatrix):
        raise NotImplementedError(
            f"oracle.spmv of {type(A).__name__} is not ported yet "
            "(ROADMAP queue 1 item 8: other formats)"
        )
    x = np.asarray(x)
    n = A.n
    data = np.asarray(A.data)
    y = np.zeros(n, dtype=np.result_type(data.dtype, x.dtype))
    for k, off in enumerate(A.offsets):
        i0, i1 = max(0, -off), min(n, n - off)
        y[i0:i1] += data[k, i0:i1] * x[i0 + off : i1 + off]
    return y
