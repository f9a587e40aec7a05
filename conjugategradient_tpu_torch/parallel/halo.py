"""Halo exchange and per-shard DIA products on kernel #4.

The port of ``conjugategradient_tpu/parallel/halo.py``.  The reference
stages boundary slices of the search direction device -> host -> device,
one neighbour pair at a time (``P2Host``/``P2Device``,
``Mgcg/cuBlas/MgcgGpu/Mgcg.cu:88-113``, orchestrated by ``SyncP``,
``ConjugateGradientParallelGpu.cs:384-419``).  The JAX package makes the
same motion two cyclic ``ppermute`` shifts; here each is
``parallel.mesh.ppermute``: the boundary slab copied to the neighbour
shard's device, or sent to the process that owns it.  The functions take
and return ``parallel.mesh.Shards`` (the mesh travels with them, so the
JAX package's ``axis`` and ``num_shards`` arguments are gone).

The local product is kernel #4 (``ops.cuda_dia.spmv_dia_cuda``, its twin on
a CPU tensor): each shard's rows become a square DIA over ``n_local +
2*halo`` rows whose ``halo`` first and last rows are zero
(``extend_rows``), applied to the halo-padded vector; the local rows are the
middle of the result, and the padded rows of the result are exactly zero,
so the fused ``spmv_dot_dia_cuda`` returns the shard's p.Ap (for a finite
p).  That costs ``2*halo`` extra rows a shard (158 of 51,851 on the flagship
at four shards) and no change to the kernel.

Ring wraparound: the shifts are cyclic, so the first and last shards
receive wrapped values in their halos.  DIA stores structural zeros
wherever ``i + offset`` leaves ``[0, n)``, so wrapped values are multiplied
by zero (``tests/test_torch_parallel.py`` holds the wraparound case to the
JAX package bit for bit).  The all-gather product pads the gathered vector
with zeros instead, as the JAX package's does.

``HaloDia`` takes k columns as well, a shard's ``(k, n_local)`` block:
one halo pair moves the ``(k, halo)`` slabs of every column, and kernel #5
(``spmm_dia_cuda``) takes the extended block in one call.

The grid-stencil counterpart (``HaloStencil``, ``spmv_stencil_shard``: the
port of ``conjugategradient_tpu/parallel/shard_mgcg.py::spmv_stencil_shard``)
moves the same pattern from DIA rows to grid rows: each shard holds an
axis-0 block ``(g0/num, *rest)`` of the grid, its legs extended by ``halo0``
zero grid rows each side, and kernel #3 (``ops.cuda_stencil.
spmv_stencil_cuda``, tuned or wide by ``var_route``) runs on the extended
slab; the local rows are the middle of its result.  Over a 2-D mesh each
shard holds a 2-D block ``(g0/px, g1/py, *rest)``, its legs extended on
axes 0 and 1; the exchange runs axis 0 along the mesh's first axis, then
axis 1 along its second over the axis-0-extended rows, so the corner
values that 9- and 27-point stencils read arrive with the faces.  The
wrapped halos at the global edges meet the legs' structural zeros, as in
the JAX package.
Legs assembled inside such extended slabs in the first place
(``zero_halo_slab``, a ``SlabStencil``'s) are taken as they are by
``HaloStencil.from_slabs``.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from conjugategradient_tpu_torch.core.formats import DiaMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda, spmv_dia_cuda, spmv_dot_dia_cuda
from conjugategradient_tpu_torch.ops.cuda_stencil import spmv_stencil_cuda
from conjugategradient_tpu_torch.ops.stencil import spmm_columns
from conjugategradient_tpu_torch.parallel.mesh import Shards, all_gather, ppermute


def extend_rows(data: torch.Tensor, halo: int) -> torch.Tensor:
    """(ndiags, n_local) legs as (ndiags, n_local + 2*halo) with ``halo``
    zero rows on each side: the square DIA kernel #4 takes."""
    return F.pad(data, (halo, halo)).contiguous()


def _square(data: torch.Tensor, offsets) -> DiaMatrix:
    L = data.shape[1]
    return DiaMatrix(data, tuple(offsets), (L, L))


def halo_exchange(p: Shards, halo: int) -> Shards:
    """Each shard's p padded with its neighbours' boundary slices:
    ``[left neighbour's tail | p | right neighbour's head]``, of
    ``n_local + 2*halo`` rows."""
    if halo == 0:
        return p
    left, right = exchange_halos(p, halo)
    return Shards.map(lambda l_, p_, r_: torch.cat([l_, p_, r_]), left, p, right)


def spmv_dia_local(data_local: Shards, offsets: Tuple[int, ...], p_padded: Shards,
                   halo: int) -> Shards:
    """Local rows of y = A p from the halo-padded p (``halo_exchange``):
    kernel #4 on each shard's extended DIA (``extend_rows``), the middle
    ``n_local`` rows kept.  ``data_local`` holds each shard's rows of the
    global DIA data (row-indexed, so no rebasing)."""
    n_local = data_local.shape[1]
    return Shards.map(
        lambda d, p: spmv_dia_cuda(_square(extend_rows(d, halo), offsets), p)[halo:halo + n_local],
        data_local, p_padded)


def exchange_halos(p: Shards, halo: int, dim: int = -1) -> Tuple[Shards, Shards]:
    """The two neighbour slices along ``dim`` (a vector's rows), apart:
    ``(left, right)`` with left the left neighbour's last ``halo`` rows and
    right the right neighbour's first ``halo`` rows."""
    left = ppermute(Shards.map(lambda t: t.narrow(dim, t.shape[dim] - halo, halo), p), 1)
    right = ppermute(Shards.map(lambda t: t.narrow(dim, 0, halo), p), -1)
    return left, right


def spmv_dia_local_overlap(data_local: Shards, offsets: Tuple[int, ...], p: Shards,
                           halo: int) -> Shards:
    """The JAX package's halo-overlap SpMV, whose dataflow lets XLA run the
    permutes under the interior rows.  The port's copies are stream-ordered
    device copies of ``2*halo`` rows, and kernel #4 takes every row of a
    shard in one launch, so this is ``spmv_dia_local`` on
    ``halo_exchange``: the same values, bit for bit."""
    return spmv_dia_local(data_local, offsets, halo_exchange(p, halo), halo)


def extend_dia_data(data_local: Shards, H: int) -> Shards:
    """(ndiags, n_local + 2H) legs extended with the neighbours' boundary
    rows: the static half of the matrix-powers kernel, exchanged once per
    solve."""
    if H == 0:
        return data_local
    left = ppermute(Shards.map(lambda d: d[:, -H:], data_local), 1)
    right = ppermute(Shards.map(lambda d: d[:, :H], data_local), -1)
    return Shards.map(lambda l_, d, r_: torch.cat([l_, d, r_], dim=1).contiguous(),
                      left, data_local, right)


def dia_basis_powers(data_ext: Shards, offsets: Tuple[int, ...], p: Shards, r: Shards, s: int,
                     halo: int) -> Shards:
    """The matrix-powers kernel: each shard's (2s+1, n_local) CA-CG basis
    rows ``[p, Ap, ..., A^s p, r, Ar, ..., A^{s-1} r]`` from one widened
    exchange (width H = s*halo, both vectors' slabs in one message each
    way) instead of one exchange per product.

    With the legs extended by ``extend_dia_data``, each product of the
    extended vector (kernel #4 on the (ndiags, n_local + 2H) DIA) is exact
    on a region that shrinks by ``halo`` rows a product, so after s products
    the middle ``n_local`` rows are still exact.  Requires H <= n_local."""
    H = s * halo
    n_local = p.shape[0]
    tails = ppermute(Shards.map(lambda a, b: torch.stack([a[-H:], b[-H:]]), p, r), 1)
    heads = ppermute(Shards.map(lambda a, b: torch.stack([a[:H], b[:H]]), p, r), -1)

    def local(d, p_, r_, lefts, rights):
        A = _square(d, offsets)
        rows = []
        for j, (v, k) in enumerate(((p_, s), (r_, s - 1))):
            rows.append(v)
            cur = torch.cat([lefts[j], v, rights[j]])
            for _ in range(k):
                cur = spmv_dia_cuda(A, cur)
                rows.append(cur[H:H + n_local])
        return torch.stack(rows)

    return Shards.map(local, data_ext, p, r, tails, heads)


def ring_gather(p: Shards, hops: int) -> Shards:
    """Multi-hop block collection: each shard's ``[p of shard i-hops | ... |
    p | ... | p of shard i+hops]``, ``(2*hops + 1) * n_local`` rows, one
    cyclic shift each way per hop.  Consumers index it as ``global_col -
    (shard_offset - hops * n_local)``; wraparound at the global edges is
    harmless when ``hops`` comes from ``core.partition.halo_hops``."""
    if hops == 0:
        return p
    lefts, rights = [], []
    cl = cr = p
    for _ in range(hops):
        cl = ppermute(cl, 1)  # after h hops: p of shard i-h
        cr = ppermute(cr, -1)  # after h hops: p of shard i+h
        lefts.append(cl)
        rights.append(cr)
    return Shards.map(lambda *vs: torch.cat(vs), *reversed(lefts), p, *rights)


def _gathered_window(g: torch.Tensor, row0: int, n_local: int, B: int) -> torch.Tensor:
    """Rows [row0 - B, row0 + n_local + B) of the zero-padded global g."""
    return F.pad(g, (B, B))[row0:row0 + n_local + 2 * B]


def spmv_dia_allgather(data_local: Shards, offsets: Tuple[int, ...], p: Shards) -> Shards:
    """The all-gather SpMV for ``bandwidth > n_local``: the global p on every
    shard (one ``all_gather``), each shard's window of it zero-padded at the
    global edges, and kernel #4 on the shard's extended DIA.  O(n) traffic
    per product instead of O(halo): ``make_sharded_cg`` takes it only where
    the halo does not fit a shard."""
    n_local = data_local.shape[1]
    B = max((abs(o) for o in offsets), default=0)
    g = all_gather(p)
    rows0 = [i * n_local for i in p.mesh.owned]
    return Shards.map(
        lambda d, g_, row0: spmv_dia_cuda(_square(extend_rows(d, B), offsets),
                                          _gathered_window(g_, row0, n_local, B))[B:B + n_local],
        data_local, g, Shards(rows0, p.mesh))


def exchange_bytes(offsets, n: int, num: int, itemsize: int) -> int:
    """Bytes one sharded DIA product moves between ``num`` shards of an
    n-row matrix: ``2 * halo`` rows a shard on the halo route, the other
    shards' rows on the all-gather route (bandwidth past ``n / num``)."""
    n_local = n // num
    halo = max((abs(o) for o in offsets), default=0)
    rows = num * (num - 1) * n_local if halo > n_local else num * 2 * halo
    return rows * itemsize


def _halo_tuple(halo) -> Tuple[int, ...]:
    return (int(halo),) if isinstance(halo, (int, np.integer)) else tuple(int(h) for h in halo)


class _HaloBuffers:
    """Two halo-padded buffers a shard that alternate as operand storage:
    each shard's ``local`` extents (the trailing dims) with ``halos[a]``
    rows more on each side of the a-th of them.  ``_take(p)`` copies ``p``
    into the middle of the buffer not holding the last operand, unless
    ``p`` lies in a buffer's middle already (``fresh()`` hands those out),
    and ``_exchange`` fills the halo rows from the neighbours: one
    ``ppermute`` pair an axis, every leading column's slab together.  One
    halo axis runs over the flat ring of the mesh; two (grid blocks on a
    2-D mesh) run axis 0 along the mesh's first axis, then axis 1 along its
    second over the rows axis 0 extended, so the corner values arrive too.
    ``halo`` is the first axis's width.  A product never overwrites its own
    operand; a caller that keeps a vector in a buffer must not share the
    operator."""

    def __init__(self, mesh, halos, local: Tuple[int, ...]):
        self.mesh = mesh
        self.halos = _halo_tuple(halos)
        self.halo = self.halos[0]
        self.local = tuple(local)
        self._bufs = None
        self._last = 0

    def _buffers(self, like: Shards):
        d = len(self.local)
        nb = len(self.halos)
        ext = tuple(n + 2 * h for n, h in zip(self.local, self.halos)) + self.local[nb:]
        shape = tuple(like.shape[:-d]) + ext
        if (self._bufs is None or self._bufs[0].dtype != like.dtype
                or tuple(self._bufs[0].shape) != shape):
            self._bufs = [Shards.map(lambda p: torch.zeros(shape, dtype=p.dtype, device=p.device),
                                     like) for _ in range(2)]
        return self._bufs

    def _narrowed(self, b: torch.Tensor, axes) -> torch.Tensor:
        """``b`` cut to the middle on the halo axes in ``axes``."""
        d0 = -len(self.local)
        for a in axes:
            b = b.narrow(d0 + a, self.halos[a], self.local[a])
        return b

    def _middle(self, buf: Shards) -> Shards:
        return Shards.map(lambda b: self._narrowed(b, range(len(self.halos))), buf)

    def fresh(self, like: Shards) -> Shards:
        """Middle rows of the buffer not holding the last operand."""
        return self._middle(self._buffers(like)[1 - self._last])

    def _take(self, p: Shards) -> Shards:
        bufs = self._buffers(p)
        mids = [self._middle(b) for b in bufs]
        held = [k for k in (0, 1)
                if all(q.data_ptr() == m.data_ptr() and q.shape == m.shape
                       and q.stride() == m.stride() for q, m in zip(p.parts, mids[k].parts))]
        k = held[0] if held else 1 - self._last
        self._last = k
        if not held:
            for q, m in zip(p.parts, mids[k].parts):
                m.copy_(q)
        return bufs[k]

    def _exchange(self, buf: Shards) -> None:
        d0 = -len(self.local)
        ring = len(self.halos) == 1
        for a, H in enumerate(self.halos):
            if H == 0:
                continue
            dim, n = d0 + a, self.local[a]
            # the axes before a extended already, those after it not yet
            v = Shards.map(lambda b: self._narrowed(b, range(a + 1, len(self.halos))), buf)
            along = None if ring else a
            left = ppermute(Shards.map(lambda t: t.narrow(dim, n, H), v), 1, along)
            right = ppermute(Shards.map(lambda t: t.narrow(dim, H, H), v), -1, along)
            for l_, r_, t in zip(left.parts, right.parts, v.parts):
                t.narrow(dim, 0, H).copy_(l_)
                t.narrow(dim, H + n, H).copy_(r_)


class HaloDia(_HaloBuffers):
    """The sharded DIA product of ``make_sharded_cg``: each shard's extended
    DIA (``extend_rows``) built once, and two halo-padded buffers a shard
    that alternate as the search direction's storage.

    ``op(p)`` fills the padded rows of a buffer (the neighbours' slabs by
    ``ppermute``, or the gathered window on the all-gather route) and runs
    kernel #4 once per shard; ``spmv_dot(p)`` runs the fused form and
    returns the local p.Ap partials too.  ``fresh()`` hands out the middle
    rows of the buffer that does not hold the last operand: a solver that
    writes its next direction there (``torch.mul(..., out=)``) saves the
    copy of p into the buffer.  Any other operand is copied in.
    ``halo_bytes`` is what one product moves between shards (times k for
    a block).

    A shard's ``(k, n_local)`` block of k columns takes ``(k, n_local +
    2*halo)`` buffers, its halo slabs of all k columns in one pair, and
    kernel #5 on the extended DIA, one call a shard (``spmm_dia_cuda``)."""

    def __init__(self, data: Shards, offsets: Tuple[int, ...], halo: int, allgather: bool):
        self.offsets = tuple(offsets)
        self.n_local = n = data.shape[1]
        self.allgather = allgather
        H = max((abs(o) for o in offsets), default=0) if allgather else halo
        super().__init__(data.mesh, H, (n,))
        self.mats = Shards.map(lambda d: _square(extend_rows(d, H), offsets), data)
        self.halo_bytes = exchange_bytes(self.offsets, n * self.mesh.size, self.mesh.size,
                                         data.dtype.itemsize)

    def _fill(self, p: Shards) -> Shards:
        buf = self._take(p)
        H, n = self.halo, self.n_local
        if self.allgather:
            g = all_gather(p, dim=-1)
            for i, g_, b in zip(self.mesh.owned, g.parts, buf.parts):
                lo = i * n - H
                a, z = max(lo, 0), min(lo + n + 2 * H, g_.shape[-1])
                # the middle is p itself; the rest of the window, and zeros
                # beyond the global edges (written once, at allocation)
                b[..., a - lo:H].copy_(g_[..., a:i * n])
                b[..., H + n:z - lo].copy_(g_[..., (i + 1) * n:z])
        elif H:
            self._exchange(buf)
        return buf

    def __call__(self, p: Shards) -> Shards:
        """The local rows of A p (a vector: kernel #4) or A P (a ``(k,
        n_local)`` block: kernel #5), one launch a shard."""
        H, n = self.halo, self.n_local
        fn = spmv_dia_cuda if p.parts[0].dim() == 1 else spmm_dia_cuda
        return Shards.map(lambda A, b: fn(A, b)[..., H:H + n], self.mats, self._fill(p))

    def spmv_dot(self, p: Shards) -> Tuple[Shards, Shards]:
        """``(A p, local p.Ap)``: the fused kernel #4 on each shard."""
        H, n = self.halo, self.n_local
        out = Shards.map(spmv_dot_dia_cuda, self.mats, self._fill(p))
        return (Shards([y[H:H + n] for y, _ in out.parts], self.mesh),
                Shards([d for _, d in out.parts], self.mesh))


# ---------------------------------------------------------------------------
# grid stencils: axis-0 row blocks on kernel #3
# ---------------------------------------------------------------------------


def extend_grid_rows(legs: torch.Tensor, halo0) -> torch.Tensor:
    """A shard's ``(L, n0, *rest)`` legs as ``(L, n0 + 2*halo0, *rest)``
    with ``halo0`` zero grid rows on each side: the slab kernel #3 takes.
    A pair ``(h0, h1)`` extends a 2-D block on axes 0 and 1."""
    H = _halo_tuple(halo0)
    if not any(H):
        return legs.contiguous()
    pad = []
    for dim in range(legs.dim() - 1, 0, -1):
        h = H[dim - 1] if dim - 1 < len(H) else 0
        pad += [h, h]
    return F.pad(legs, pad).contiguous()


def zero_halo_slab(nlegs: int, local, halo0, dtype, device):
    """A shard's legs allocated inside a zeroed slab: ``(slab, legs)``, the
    slab ``(nlegs, n0 + 2*halo0, *rest)`` and the legs its middle rows
    ``(nlegs, n0, *rest)`` (a view), which an assembly fills.  A pair
    ``(h0, h1)`` pads a 2-D block on axes 0 and 1.
    ``HaloStencil.from_slabs`` takes such slabs as its extended legs, with
    no second copy."""
    local = tuple(int(n) for n in local)
    H = _halo_tuple(halo0)
    ext = tuple(n + 2 * h for n, h in zip(local, H)) + local[len(H):]
    slab = torch.zeros((nlegs,) + ext, dtype=dtype, device=device)
    legs = slab
    for a, h in enumerate(H):
        legs = legs.narrow(1 + a, h, local[a])
    return slab, legs


class HaloStencil(_HaloBuffers):
    """The sharded stencil product of the sharded V-cycle: each shard's
    block of the legs extended once (``extend_grid_rows``), and two
    halo-padded buffers a shard.

    The blocks are axis-0 row blocks ``(n0, *rest)`` over a 1-D mesh
    (``halo0`` an int), or 2-D blocks ``(n0, n1, *rest)`` over a 2-D mesh
    (``halo0`` the pair of halos of axes 0 and 1), each extended on its
    sharded axes.  ``op(x)`` takes a ``Shards`` of such blocks, or of k
    columns ``(k, n0, ...)``; it copies the block into the middle of a
    buffer unless it lives there already (``fresh``, as ``HaloDia``'s),
    fills the halos from the neighbours (one ``ppermute`` pair an axis,
    axis 1 over the axis-0-extended rows so the corners reach 9- and
    27-point stencils), and runs kernel #3 on the extended block once a
    shard (once a column a shard for a block, as ``ops.stencil.
    spmm_columns`` does); the local block is the middle of the result.
    ``from_slabs`` takes legs extended already (``zero_halo_slab``'s
    slabs) as they are.  ``sibling()`` gives an operator over the same
    extended legs with buffers of its own, for a second user.
    ``halo_bytes`` is what one product of one column moves between shards,
    both axes counted."""

    def __init__(self, legs: Shards, shifts, halo0):
        H = _halo_tuple(halo0)
        self._setup(Shards.map(lambda d: extend_grid_rows(d, H), legs), shifts, H)

    @classmethod
    def from_slabs(cls, slabs: Shards, shifts, halo0) -> "HaloStencil":
        """The product over legs extended already: each shard's ``(L, n0 +
        2*halo0, *rest)`` slab (extended on both axes of a 2-D block), zero
        in its halos, taken as it is."""
        op = cls.__new__(cls)
        op._setup(slabs, shifts, _halo_tuple(halo0))
        return op

    def _setup(self, slabs: Shards, shifts, H: Tuple[int, ...]):
        ext = tuple(slabs.shape[1:])
        local = tuple(n - 2 * h for n, h in zip(ext, H)) + ext[len(H):]
        super().__init__(slabs.mesh, H, local)
        self.shifts = tuple(tuple(int(v) for v in s) for s in shifts)
        self.mats = Shards.map(lambda d: StencilMatrix(d, self.shifts, ext), slabs)
        face = lambda a: math.prod(ext[b] if b < a else local[b] for b in range(len(ext)) if b != a)
        self.halo_bytes = (self.mesh.size * sum(2 * h * face(a) for a, h in enumerate(H))
                           * slabs.dtype.itemsize)

    def sibling(self) -> "HaloStencil":
        """The same operator (the same extended legs) with buffers of its
        own."""
        twin = copy.copy(self)
        twin._bufs, twin._last = None, 0
        return twin

    def _fill(self, x: Shards) -> Shards:
        buf = self._take(x)
        self._exchange(buf)
        return buf

    def __call__(self, x: Shards) -> Shards:
        d = len(self.local)

        def local(A, b):
            y = spmv_stencil_cuda(A, b) if b.dim() == d else spmm_columns(A, b)
            return self._narrowed(y, range(len(self.halos)))

        return Shards.map(local, self.mats, self._fill(x))


def spmv_stencil_shard(legs: Shards, shifts, x: Shards, halo0: int) -> Shards:
    """Local rows of a stencil SpMV on axis-0 row blocks: each shard's
    ``(n0, *rest)`` block of x (and ``(L, n0, *rest)`` block of the legs),
    one ``ppermute`` pair of ``halo0``-row slabs, kernel #3 on the extended
    slab.  The one-call form of ``HaloStencil`` (which builds the extended
    legs once for many products)."""
    return HaloStencil(legs, shifts, halo0)(x)


@dataclasses.dataclass(frozen=True)
class SlabStencil(StencilMatrix):
    """A grid stencil assembled onto the shards (``parallel.rung5``):
    ``data`` is a ``Shards`` of axis-0 blocks ``(nlegs, g0 / num, *rest)``,
    each the middle rows of its shard's zeroed slab in ``slabs``, ``halo0``
    grid rows wider on each side (``zero_halo_slab``); ``op()`` is the
    sharded product over those slabs themselves.  ``real0`` is axis 0's
    real extent: the rows from it on are identity padding."""

    slabs: Shards
    halo0: int
    real0: int

    def op(self) -> HaloStencil:
        return HaloStencil.from_slabs(self.slabs, self.shifts, self.halo0)
