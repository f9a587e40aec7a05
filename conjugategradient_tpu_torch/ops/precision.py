"""Compensated inner products for fp32 solver state.

``dot2`` captures every product's rounding error exactly (Dekker's
TwoProduct) and sums products and errors separately.  Dekker's split is only
error-free when no multiply-add is contracted into an FMA, so these stay
eager PyTorch ops, one elementwise kernel per line: do not ``torch.compile``
them or fuse them into a kernel without re-deriving the error bound.
"""

from __future__ import annotations

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


def kahan_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compensated inner product; the name the solvers use for ``dot2``."""
    return dot2(a, b)
