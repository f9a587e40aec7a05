"""Compensated inner products and sums for fp32 solver state.

``dot2`` captures every product's rounding error exactly (Dekker's
TwoProduct) and sums products and errors separately.  ``dd_sum`` is a
double-float (hi, lo) halving tree, every level one vectorised TwoSum
(Knuth), so its error is O(n eps^2) with no sequential scan; ``dd_dot``
feeds it the error-free products and ``kahan_sum`` a plain vector.
``promote_dot`` is a dot in an explicit accumulation dtype.  Dekker's split
and the TwoSum are only error-free when no multiply-add is contracted into
an FMA and no add is reassociated, so these stay eager PyTorch ops, one
elementwise kernel per operator: do not ``torch.compile`` them or fuse them
into a kernel without re-deriving the error bound.  They run on any device.

``no_tf32`` keeps the dense and block products of ``ops.spmv`` and
``ops.spmm`` in full fp32 on the card.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

#: Dekker split factors: 2^ceil(m/2) + 1 for an m-bit mantissa.
_SPLIT = {torch.float32: 4097.0, torch.float64: 134217729.0}


def _split(a: torch.Tensor):
    f = _SPLIT.get(a.dtype, 4097.0)
    c = a * f
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: torch.Tensor, b: torch.Tensor):
    """Error-free product: a*b = p + e exactly (Dekker, FMA-free)."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated inner product: error-free products, plain tree sums of
    (p, e).  Error ~ tree-sum error instead of the naive random walk."""
    p, e = two_prod(a, b)
    return torch.sum(p) + torch.sum(e)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """Error-free sum: a + b = s + e exactly (Knuth's TwoSum)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def dd_sum(p: torch.Tensor, e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Double-float binary-tree sum of ``p`` (plus the companion errors
    ``e``): each level pairs neighbours (a zero pads an odd level), adds the
    pairs by ``_two_sum`` and carries the errors beside them, so the whole
    reduction is about 4n element ops with error O(n eps^2).  Returns a
    0-d tensor in ``p``'s dtype."""
    s = p.reshape(-1)
    c = torch.zeros_like(s) if e is None else e.reshape(-1)
    while s.shape[0] > 1:
        if s.shape[0] % 2:
            s = torch.nn.functional.pad(s, (0, 1))
            c = torch.nn.functional.pad(c, (0, 1))
        s2, c2 = s.reshape(-1, 2), c.reshape(-1, 2)
        s, err = _two_sum(s2[:, 0], s2[:, 1])
        c = c2[:, 0] + c2[:, 1] + err
    return s[0] + c[0]


def dd_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Near-fp64 inner product of fp32 vectors: error-free products summed
    by the double-float tree (error O(n eps^2)); for a dot that is itself
    the result (norm reporting, validation)."""
    p, e = two_prod(a, b)
    return dd_sum(p, e)


def kahan_sum(x: torch.Tensor) -> torch.Tensor:
    """Compensated sum: the ``dd_sum`` tree, every pairwise add error-free,
    so large/small cancellation survives."""
    return dd_sum(x)


def promote_dot(a: torch.Tensor, b: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Dot with an explicit accumulation dtype (e.g. bf16 storage, fp32
    accumulation); ``dtype`` is a torch or numpy dtype."""
    from conjugategradient_tpu_torch.core.formats import torch_dtype

    dt = torch_dtype(dtype)
    return torch.dot(a.reshape(-1).to(dt), b.reshape(-1).to(dt))


def kahan_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated inner product; the name the solvers use for ``dot2``."""
    return dot2(a, b)


@contextlib.contextmanager
def no_tf32():
    """CUDA matmuls in full fp32 inside the block (TF32 keeps about three
    decimal digits): the port's form of the JAX package's
    ``Precision.HIGHEST`` pins.  The previous setting comes back on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
