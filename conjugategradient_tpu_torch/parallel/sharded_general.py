"""General-sparsity sharded CG: exact halo ranges over CSR and ELL row blocks.

The port of ``conjugategradient_tpu/parallel/sharded_general.py``.  The DIA
solver (``parallel.sharded_cg``) takes its halo from the band.  The
reference's flagship discovers each shard's exact column window
``[minJ, maxJ]`` at init (``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:82-84``), exchanges
that window every iteration (``ConjugateGradientParallelGpu.cs:384-419``)
and falls back to a global-length ``vectorP`` (:321) when the window is the
whole vector.  Here, as in the JAX package:

- the exact ranges come from the host at partition time
  (``native.halo_ranges``, the host kit's, or ``core.partition``'s numpy
  twin without it) and are distilled into ``hops``, how many shards away a
  window reaches (``core.partition.hops_from_ranges``);
- each shard's block keeps its column indices rebased into the coordinates
  of a ``(2*hops + 1) * n_local`` ring window (``parallel.halo.ring_gather``),
  or global ones where the ring would cover most of the vector
  (``2*hops + 1 >= num_shards``: one ``all_gather`` per product instead);
- the CSR ring splits every nonzero into an interior set (columns of the
  shard's own block, applied to the local vector) and a boundary set
  (applied to the ring window), the JAX package's halo-overlap split;
- the recurrence is ``sharded_cg.sharded_cg_loop``'s.

The JAX package computes these products outside its Pallas kernels, and so
does the port: a shard's CSR block is ``ops.spmv.spmv_csr`` (cuSPARSE on the
card), its ELL block the gather of ``ops.spmv.spmv_ell``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import CsrMatrix, EllMatrix, torch_dtype
from conjugategradient_tpu_torch.core.partition import RowBlockPartition, hops_from_ranges
from conjugategradient_tpu_torch.ops.spmv import spmv_csr, spmv_ell
from conjugategradient_tpu_torch.parallel.halo import ring_gather
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, all_gather, make_mesh
from conjugategradient_tpu_torch.parallel.sharded_cg import _shards, sharded_cg_loop
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _ell_hops(A: EllMatrix, part: RowBlockPartition) -> int:
    """``halo_hops`` for ELL: each shard's column range straight from
    ``cols`` (padding slots point at the row's own index, always in the
    shard)."""
    cols = np.asarray(A.cols)
    ranges = [(int(cols[off:off + cnt].min()), int(cols[off:off + cnt].max()))
              for off, cnt in zip(part.offsets, part.counts)]
    return hops_from_ranges(ranges, part)


def _csr_hops(A: CsrMatrix, part: RowBlockPartition) -> int:
    """``halo_hops`` for CSR from the exact ranges of the host kit."""
    from conjugategradient_tpu_torch import native

    return hops_from_ranges(native.halo_ranges(A, part), part)


def _csr_shard_arrays(A: CsrMatrix, part: RowBlockPartition, hops: int, rebase: bool):
    """Uniform per-shard (data, cols, rows) blocks, padded to the largest
    shard's nnz.

    ``rebase=True`` shifts columns into ring-window coordinates (``col -
    shard_offset + hops * n_local``), ``rebase=False`` keeps global ones
    (the all-gather path).  Padding entries carry data 0, row
    ``n_local - 1`` (rows stay ascending) and an in-range column."""
    num, n_local = part.num_shards, part.counts[0]
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    row_ids = np.asarray(A.row_ids)
    data = np.asarray(A.data)
    spans = [(int(indptr[o]), int(indptr[o + c])) for o, c in zip(part.offsets, part.counts)]
    nnz_max = max(hi - lo for lo, hi in spans)
    pad_col = hops * n_local if rebase else 0
    data_sh = np.zeros((num, nnz_max), dtype=data.dtype)
    cols_sh = np.full((num, nnz_max), pad_col, dtype=np.int32)
    rows_sh = np.full((num, nnz_max), n_local - 1, dtype=np.int32)
    for s, ((lo, hi), off) in enumerate(zip(spans, part.offsets)):
        m = hi - lo
        data_sh[s, :m] = data[lo:hi]
        cols_sh[s, :m] = indices[lo:hi] + ((hops * n_local - off) if rebase else 0)
        rows_sh[s, :m] = row_ids[lo:hi] - off
    return data_sh, cols_sh, rows_sh


def _csr_shard_arrays_overlap(A: CsrMatrix, part: RowBlockPartition, hops: int):
    """Entry-split shard arrays for the halo-overlap CSR product: every
    nonzero lands in one of two sets, interior (column in the shard's own
    block, local coordinates) or boundary (a neighbour's column, ring-window
    coordinates).  Both keep ``_csr_shard_arrays``'s padding and their rows
    ascending."""
    num, n_local = part.num_shards, part.counts[0]
    indptr = np.asarray(A.indptr)
    indices = np.asarray(A.indices)
    row_ids = np.asarray(A.row_ids)
    data = np.asarray(A.data)
    per_shard = []
    for off, cnt in zip(part.offsets, part.counts):
        lo, hi = int(indptr[off]), int(indptr[off + cnt])
        c = indices[lo:hi]
        local = (c >= off) & (c < off + n_local)
        per_shard.append((
            (data[lo:hi][local], c[local] - off, row_ids[lo:hi][local] - off),
            (data[lo:hi][~local], c[~local] - off + hops * n_local, row_ids[lo:hi][~local] - off),
        ))
    out = []
    for which, pad_col in ((0, 0), (1, hops * n_local)):
        nnz_max = max(1, max(len(ps[which][0]) for ps in per_shard))
        d = np.zeros((num, nnz_max), dtype=data.dtype)
        cc = np.full((num, nnz_max), pad_col, dtype=np.int32)
        rr = np.full((num, nnz_max), n_local - 1, dtype=np.int32)
        for s, ps in enumerate(per_shard):
            dv, cv, rv = ps[which]
            m = len(dv)
            d[s, :m], cc[s, :m], rr[s, :m] = dv, cv, rv
        out.append((d, cc, rr))
    return out[0], out[1]


def _blocks(mesh: Mesh, triplets, n_local: int, n_cols: int) -> Shards:
    """One shard's (data, cols, rows) row of the padded arrays as a device
    ``CsrMatrix`` of ``(n_local, n_cols)`` on each shard."""
    data, cols, rows = triplets
    out = []
    for s, dev in mesh.shards():
        indptr = np.zeros(n_local + 1, dtype=np.int32)
        indptr[1:] = np.cumsum(np.bincount(rows[s], minlength=n_local))
        out.append(CsrMatrix(data[s], cols[s], indptr, rows[s], (n_local, n_cols))
                   .device_put(device=dev))
    return Shards(out, mesh)


def make_sharded_cg_general(
    A,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    M_local: Optional[Callable] = None,
    variant: str = "cg",
):
    """Build a sharded CG for a host CSR or ELL matrix with exact halos.

    Returns ``(solve, inputs)``: ``solve(*inputs, b, x0[, m_aux]) ->
    CGResult`` with ``inputs`` the per-shard blocks already on the mesh's
    devices (pass them back as they are; new values of one sparsity reuse
    them), ``b`` and ``x0`` ``Shards`` or global arrays; ``solve.hops`` and
    ``solve.route`` (``"ring"`` or ``"all-gather"``) say how it exchanges.  Requires
    ``A.n % num_shards == 0``."""
    mesh.one_process("make_sharded_cg_general")
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards")
    part = RowBlockPartition.equal(n, num)
    n_local = n // num
    if isinstance(A, EllMatrix):
        hops = _ell_hops(A, part)
    elif isinstance(A, CsrMatrix):
        hops = _csr_hops(A, part)
    else:
        raise TypeError(f"make_sharded_cg_general wants CsrMatrix or EllMatrix, got {type(A)}")
    # ring window or all-gather: the ring moves 2*hops*n_local values a
    # product, the gather (num - 1)*n_local; take the gather once the ring
    # would replicate most of the vector anyway
    use_allgather = 2 * hops + 1 >= num
    window = n if use_allgather else (2 * hops + 1) * n_local

    def gathered(p):
        return all_gather(p) if use_allgather else ring_gather(p, hops)

    if isinstance(A, EllMatrix):
        cols = np.asarray(A.cols, dtype=np.int32).copy()
        if not use_allgather:
            for off, cnt in zip(part.offsets, part.counts):
                cols[off:off + cnt] += hops * n_local - off
        data = np.asarray(A.data)
        spans = [(part.offsets[i], part.counts[i], d) for i, d in mesh.shards()]
        inputs = (Shards([EllMatrix(data[o:o + c], cols[o:o + c], (n_local, window))
                          .device_put(device=d) for o, c, d in spans], mesh),)

        def local_op(ell):
            return lambda p: Shards.map(spmv_ell, ell, gathered(p))

    elif use_allgather:
        inputs = (_blocks(mesh, _csr_shard_arrays(A, part, hops, rebase=False), n_local, n),)

        def local_op(csr):
            return lambda p: Shards.map(spmv_csr, csr, all_gather(p))

    else:
        interior, boundary = _csr_shard_arrays_overlap(A, part, hops)
        inputs = (_blocks(mesh, interior, n_local, n_local),
                  _blocks(mesh, boundary, n_local, window))

        def local_op(c_int, c_bnd):
            # interior entries read the local rows only; boundary entries
            # the ring window
            return lambda p: (Shards.map(spmv_csr, c_int, p)
                              + Shards.map(spmv_csr, c_bnd, ring_gather(p, hops)))

    def solve(*args):
        args = list(args)
        m_aux = args.pop() if M_local is not None else None
        mats, (b, x0) = args[:-2], args[-2:]
        b = _shards(mesh, b, None)
        x0 = _shards(mesh, x0, b.dtype)
        M = (lambda r: r) if M_local is None else (
            lambda r, aux=_shards(mesh, m_aux, b.dtype): Shards.map(M_local, r, aux))
        res = sharded_cg_loop(local_op(*mats), M, b, x0, policy, n, variant=variant)
        return dataclasses.replace(res, x=res.x.gather())

    solve.hops = hops
    solve.route = "all-gather" if use_allgather else "ring"
    return solve, inputs


def sharded_cg_solve_general(
    A,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    dtype=None,
    variant: str = "cg",
) -> CGResult:
    """One-call convenience: split a host CSR/ELL system over the mesh
    (every visible CUDA device by default) and solve with exact-halo
    exchanges, in ``dtype`` (default ``A.data``'s)."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    dt = torch_dtype(dtype if dtype is not None else np.asarray(A.data).dtype)
    np_dt = torch.empty(0, dtype=dt).numpy().dtype
    if np.asarray(A.data).dtype != np_dt:
        A = A.astype(np_dt)
    solve, inputs = make_sharded_cg_general(A, mesh, policy, axis=axis, M_local=M_local,
                                            variant=variant)
    b_sh = _shards(mesh, b, dt)
    x0_sh = Shards.map(torch.zeros_like, b_sh) if x0 is None else _shards(mesh, x0, dt)
    extra = () if M_local is None else (_shards(mesh, M_aux, dt),)
    return solve(*inputs, b_sh, x0_sh, *extra)
