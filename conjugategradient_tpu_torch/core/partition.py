"""Row-block partition math with halo-range discovery.

A numpy-only copy of ``conjugategradient_tpu/core/partition.py``, over the
port's ``core.formats`` containers and ``core.generators.LinearSystem``:

- equal, remainder-aware row splits (the first ``n % num_shards`` shards
  take one extra row);
- each shard's exact halo column range ``[minJ, maxJ]`` from its CSR
  column indices (``halo_ranges_from_csr``; ``native.halo_ranges`` is its
  C++ counterpart), and the neighbour distance those ranges need
  (``halo_hops``, ``hops_from_ranges``); for a DIA matrix the halo is its
  bandwidth (``halo_width``);
- per-shard blocks of a DIA matrix's legs (``partition_dia``), after
  ``pad_system`` has padded the rows to a multiple of the shard count with
  decoupled identity rows (x_pad = b_pad = 0), which leave the solution in
  the first n entries exactly as it was.

Host math only: nothing here touches a device.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from conjugategradient_tpu_torch.core.formats import CsrMatrix, DiaMatrix
from conjugategradient_tpu_torch.core.generators import LinearSystem


@dataclasses.dataclass(frozen=True)
class RowBlockPartition:
    """A 1-D contiguous row partition over ``num_shards`` devices."""

    n: int
    num_shards: int
    offsets: Tuple[int, ...]  # start row per shard, length num_shards
    counts: Tuple[int, ...]  # rows per shard

    @staticmethod
    def equal(n: int, num_shards: int) -> "RowBlockPartition":
        """Remainder-aware split: the first ``n % num_shards`` shards get one
        extra row."""
        base, rem = divmod(n, num_shards)
        counts = tuple(base + (1 if s < rem else 0) for s in range(num_shards))
        offsets = tuple(int(x) for x in np.cumsum((0,) + counts[:-1]))
        return RowBlockPartition(n, num_shards, offsets, counts)

    @property
    def uniform(self) -> bool:
        return len(set(self.counts)) == 1


def halo_ranges_from_csr(csr: CsrMatrix, part: RowBlockPartition) -> Tuple[Tuple[int, int], ...]:
    """Each shard's exact column range ``(minJ, maxJ)``; ``(offset,
    offset)`` for a shard with no entries."""
    out = []
    indptr = np.asarray(csr.indptr)
    indices = np.asarray(csr.indices)
    for off, cnt in zip(part.offsets, part.counts):
        lo, hi = int(indptr[off]), int(indptr[off + cnt])
        if hi > lo:
            sl = indices[lo:hi]
            out.append((int(sl.min()), int(sl.max())))
        else:
            out.append((off, off))
    return tuple(out)


def pad_system(system: LinearSystem, multiple: int) -> Tuple[LinearSystem, int]:
    """Pad a DIA system to a row count that is a multiple of ``multiple``
    with decoupled identity rows.

    Returns the padded system and the original ``n`` (to slice the solution
    back).  The appended rows have ``A[i, i] = 1``, ``b = 0``, ``x0 = 0``
    and no off-diagonal coupling, so CG on the padded system reproduces the
    original solution exactly in the first ``n`` entries.
    """
    A, b, x0 = system.A, system.b, system.x0
    n = A.n
    n_pad = ((n + multiple - 1) // multiple) * multiple
    if n_pad == n:
        return system, n
    extra = n_pad - n
    data = np.asarray(A.data)
    new = np.zeros((A.ndiags, n_pad), dtype=data.dtype)
    new[:, :n] = data
    if 0 in A.offsets:
        new[A.offsets.index(0), n:] = 1.0
    else:
        raise ValueError("cannot pad a DIA matrix with no main diagonal")
    A2 = DiaMatrix(new, A.offsets, (n_pad, n_pad))
    b2 = np.concatenate([np.asarray(b), np.zeros(extra, dtype=data.dtype)])
    x02 = np.concatenate([np.asarray(x0), np.zeros(extra, dtype=data.dtype)])
    return LinearSystem(A2, b2, x02), n


def partition_dia(A: DiaMatrix, num_shards: int) -> np.ndarray:
    """Split DIA data into equal row blocks: ``(num_shards, ndiags,
    n_local)``.

    Shard ``s`` holds ``data[:, s*n_local:(s+1)*n_local]``, the values of
    its rows.  ``data[k, i]`` indexes by row, so no rebasing is needed.
    Requires ``n % num_shards == 0`` (use ``pad_system`` first).
    """
    n = A.n
    if n % num_shards:
        raise ValueError(f"n={n} not divisible by num_shards={num_shards}; pad_system first")
    n_local = n // num_shards
    data = np.asarray(A.data)
    return data.reshape(A.ndiags, num_shards, n_local).transpose(1, 0, 2).copy()


def halo_width(A: DiaMatrix, n_local: int) -> int:
    """Halo width of a row-block shard of a DIA matrix: its bandwidth B.

    A shard's product needs x[offset - B, offset + count + B); with B <=
    n_local one exchange with each neighbour suffices."""
    B = A.bandwidth
    if B > n_local:
        raise ValueError(
            f"bandwidth {B} exceeds shard size {n_local}; use fewer shards or an "
            "all-gather product"
        )
    return B


def halo_hops(csr: CsrMatrix, part: RowBlockPartition) -> int:
    """Neighbour distance (in shards) the exact column windows require: the
    smallest h such that every shard's window from ``halo_ranges_from_csr``
    lies within h shards of its own row block.  A band no wider than a
    shard gives 1; wide or irregular sparsity more."""
    if not part.uniform:
        raise ValueError("halo_hops requires a uniform partition (pad_system first)")
    return hops_from_ranges(halo_ranges_from_csr(csr, part), part)


def hops_from_ranges(ranges, part: RowBlockPartition) -> int:
    """Smallest h such that every shard's ``(lo, hi)`` column window lies
    within h shards of its own row block (one ceil-division formula for the
    CSR and ELL paths)."""
    n_local = part.counts[0]
    hops = 0
    for (lo, hi), off, cnt in zip(ranges, part.offsets, part.counts):
        left = (off - lo + n_local - 1) // n_local if lo < off else 0
        right = (hi - (off + cnt - 1) + n_local - 1) // n_local if hi >= off + cnt else 0
        hops = max(hops, left, right)
    return hops
