"""Block-Jacobi preconditioner: batched dense inverses of the diagonal
blocks.

The port of ``conjugategradient_tpu/precond/block_jacobi.py``.  Setup is
the same host numpy (one pass over the nonzeros and a batched
``np.linalg.inv``), so the blocks equal the JAX package's bit for bit; the
apply is one ``torch.bmm`` of ``(nb, bs, bs)`` by ``(nb, bs, k)`` with TF32
off, where the JAX package runs an ``einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import (
    CsrMatrix,
    _any_to_csr,
    default_device,
    to_host,
    torch_dtype,
)
from conjugategradient_tpu_torch.ops.precision import no_tf32


def block_jacobi_blocks(A, block_size: int) -> np.ndarray:
    """The inverted diagonal blocks of a host container: ``(nb, bs, bs)``
    fp64 numpy.  Rows past ``n`` (when ``block_size`` does not divide n)
    are identity.  Raises ``numpy.linalg.LinAlgError`` for a singular
    block."""
    bs = int(block_size)
    if bs < 1:
        raise ValueError("block_size must be >= 1")
    csr = A if isinstance(A, CsrMatrix) else _any_to_csr(A)
    n = csr.shape[0]
    nb = -(-n // bs)
    rows = np.asarray(csr.row_ids, np.int64)
    cols = np.asarray(csr.indices, np.int64)
    vals = np.asarray(csr.data, np.float64)
    keep = rows // bs == cols // bs
    r, c, v = rows[keep], cols[keep], vals[keep]
    B = np.zeros((nb, bs, bs))
    np.add.at(B, (r // bs, r % bs, c % bs), v)
    pad = nb * bs - n
    if pad:
        B[-1, bs - pad :, :] = 0.0
        B[-1, :, bs - pad :] = 0.0
        B[-1, np.arange(bs - pad, bs), np.arange(bs - pad, bs)] = 1.0
    return np.linalg.inv(B)


def block_jacobi_aux(A, block_size: int, dtype=None) -> np.ndarray:
    """The inverse blocks as rows: ``(n_padded, bs)``, row ``i`` holding
    ``Binv[i // bs, i % bs, :]`` (the row-sharded carrier of the JAX
    package's distributed block Jacobi)."""
    Binv = block_jacobi_blocks(A, block_size)
    nb, bs, _ = Binv.shape
    out = Binv.reshape(nb * bs, bs)
    if dtype is not None:
        out = out.astype(dtype)
    return out


def block_jacobi_M_local(r_local: torch.Tensor, aux_local: torch.Tensor) -> torch.Tensor:
    """Apply the ``block_jacobi_aux`` layout to a vector whose length is a
    multiple of the block size: one batched product, TF32 off."""
    n_local = r_local.shape[0]
    bs = aux_local.shape[1]
    B = aux_local.reshape(n_local // bs, bs, bs)
    with no_tf32():
        return torch.bmm(B, r_local.reshape(n_local // bs, bs, 1)).reshape(n_local)


def block_jacobi_preconditioner(
    A, block_size: int, dtype=None, device=None
) -> Callable[[torch.Tensor], torch.Tensor]:
    """``M(r) = blockdiag(A)^-1 r`` for any container, its blocks on
    ``device`` (``None``: the card when there is one) in ``dtype`` (``None``:
    the matrix's).  ``M`` takes ``(n,)`` vectors and ``(n, k)`` blocks; rows
    padded to a whole block are zero in and dropped out."""
    A = to_host(A)
    n = A.shape[0]
    bs = int(block_size)
    Binv_np = block_jacobi_blocks(A, bs)
    dt = torch_dtype(dtype if dtype is not None else np.asarray(A.data).dtype)
    Binv = torch.from_numpy(Binv_np).to(device=default_device(device), dtype=dt)
    nb = Binv_np.shape[0]
    pad = nb * bs - n

    def M(r):
        flat = r.reshape(n, -1)  # (n, k); k = 1 for vectors
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad, flat.shape[1])])
        with no_tf32():
            out = torch.bmm(Binv, flat.reshape(nb, bs, -1)).reshape(nb * bs, -1)
        return out[:n].reshape(r.shape)

    return M
