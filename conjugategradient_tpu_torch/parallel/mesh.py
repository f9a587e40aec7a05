"""Device meshes, row-sharded values and the collectives between shards.

The port of ``conjugategradient_tpu/parallel/mesh.py``.  The JAX package's
mesh is single-controller: one process drives every local device, and its
solvers run one SPMD program under ``shard_map``.  The port keeps the single
controller and writes the SPMD program out:

- ``Mesh`` is a 1-D sequence of torch devices with a named axis
  (``mesh.shape[axis]`` as in JAX), or a 2-D arrangement of them with two
  axis names (``Mesh([[d] * 2] * 2, ("x", "y"))``: JAX's
  ``Mesh(devices.reshape(2, 2), ("x", "y"))``), its shards in row-major
  (x, y) order.  A mesh may repeat a device: four shards on one card
  (``make_mesh(4, devices=["cuda:0"] * 4)``) run the sharded algorithm with
  its collectives on one H100, and the same code spans ``cuda:0..3`` on a
  four-card host.
- ``Shards`` is a row-sharded value: one tensor per mesh position, on that
  position's device.  Arithmetic between ``Shards`` (and with Python
  numbers) acts shard by shard; a replicated scalar is a ``Shards`` of 0-d
  tensors.  Nothing in it reaches another shard.
- The collectives are the only way across shards: ``psum``/``pmax`` (the
  partials combined in shard order on the first shard's device, in their
  dtype, the result copied back to every shard's device), ``ppermute`` (a
  cyclic neighbour shift, each slab copied to the receiving shard's device;
  on a 2-D mesh along one of its axes, inside each row or column) and
  ``all_gather``.
- A mesh may span processes (``parallel.multihost.global_mesh``): it then
  holds a ``parallel.comm.Communicator``, and each process owns a
  contiguous block of the shards, process-major (rank r the flat indices
  ``[r * L, (r + 1) * L)``, as JAX orders a global mesh's devices).  A
  ``Shards`` holds the owned parts only; ``mesh.shards()`` pairs each with
  its global index, which is what decides a block's rows.  The collectives
  keep their meaning and their sums: ``psum``/``pmax`` gather every owned
  partial (no per-process pre-sum) and combine them left to right in
  global shard order, so the sums equal the one-process mesh's bit for bit;
  ``ppermute`` sends the slabs whose receiver another process owns point to
  point; ``all_gather`` and ``Shards.gather`` give every process the
  global value.  The solvers run unchanged: every process runs the same
  program on its own shards, and the replicated work (a tail, a
  predicate) on its first device.  On a mesh of one process the owned
  block is every shard, and nothing changes.
- Torch functions take ``Shards`` too (``__torch_function__``):
  ``torch.where(mask, a, b)``, ``torch.zeros_like(a)`` and the like run
  shard by shard, a plain tensor among their arguments standing for a
  replicated value (copied to each shard's device).  So a recurrence
  written for tensors (``solvers.cg.cg_block``, the smoothers) runs on row
  blocks unchanged, its dots and norms handed in as collectives.

``specs_for_grid`` keeps the JAX package's divisibility rule, and returns
the split a carrier needs (``GridSplit``) in place of PartitionSpecs.  A
grid sharded over a mesh lies in blocks: axis 0 over a 1-D mesh, axes 0
and 1 over a 2-D one (``shard_blocks``, ``Shards.gather_grid``).
Left out: ``factory_cache``/``_stable_key``, which cache
jitted programs: eager PyTorch traces nothing, so a rebuilt solver costs only
its setup.  For the same reason the solver factories
(``sharded_cg.make_sharded_cg``, ``sharded_general.make_sharded_cg_general``)
take no ``donate=``: there is no compiled program to hand buffers to.
"""

from __future__ import annotations

import operator
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch


class Mesh:
    """A mesh of torch devices (a device may repeat).  1-D: ``devices`` a
    sequence along the axis ``axis``, ``shape[axis]`` the number of shards.
    2-D: ``devices`` rows of equal length (a nested sequence or a 2-D
    array) and ``axis`` a pair of names, ``shape`` each axis's size.
    ``devices`` is the flat tuple in row-major order, ``dims`` the sizes in
    axis order, ``axes`` the names, and ``axis`` the one name of a 1-D mesh
    (the pair of a 2-D one).

    ``comm`` (a ``parallel.comm.Communicator``) spreads the mesh over its
    processes: ``devices`` is then every process's, rank by rank, and this
    process owns the flat indices ``owned`` (a range), on
    ``local_devices``.  Without one, one process owns every shard."""

    def __init__(self, devices: Sequence, axis="x", comm=None):
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        if len(names) == 1:
            flat, dims = list(devices), None
        elif len(names) == 2:
            rows = [list(r) for r in devices]
            if not rows or any(len(r) != len(rows[0]) for r in rows):
                raise ValueError("a 2-D mesh needs rows of devices of one length")
            flat, dims = [d for r in rows for d in r], (len(rows), len(rows[0]))
        else:
            raise ValueError(f"a mesh has one or two axes, not {names}")
        self.devices = tuple(torch.device(d) for d in flat)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.dims = dims or (len(self.devices),)
        self.axes = names
        self.axis = names[0] if len(names) == 1 else names
        self.shape = dict(zip(names, self.dims))
        self.comm = comm
        world, rank = (comm.world, comm.rank) if comm is not None else (1, 0)
        if len(self.devices) % world:
            raise ValueError(f"{len(self.devices)} shards do not split over {world} processes")
        per = len(self.devices) // world
        self.owned = range(rank * per, (rank + 1) * per)
        self.local_devices = self.devices[rank * per:(rank + 1) * per]

    def shards(self):
        """``(global index, device)`` of each shard this process owns."""
        return list(zip(self.owned, self.local_devices))

    @property
    def layout(self):
        """What two meshes must share for a ``Shards`` of one to serve the
        other: the devices, the dims and the owned block."""
        return self.devices, self.dims, self.owned

    def one_process(self, route: str) -> None:
        """Raise for ``route`` on a mesh that spans processes: the routes
        not yet held across processes (ROADMAP queue 1, item 6d)."""
        if self.comm is not None:
            raise NotImplementedError(
                f"{route} runs on a one-process mesh; across processes it waits for ROADMAP "
                "queue 1, item 6d (the sharded CG on DIA, rung 5 and shard_mgcg are ported)")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def ndim(self) -> int:
        return len(self.dims)

    def coords(self, i: int) -> Tuple[int, ...]:
        """Shard ``i``'s position along each mesh axis."""
        return (i,) if self.ndim == 1 else divmod(i, self.dims[1])

    def index(self, coords) -> int:
        """The flat shard index at ``coords``."""
        return coords[0] if self.ndim == 1 else coords[0] * self.dims[1] + coords[1]

    def check_axes(self, axes) -> Tuple[str, ...]:
        """``axes`` (one name per sharded grid axis) as a tuple: the mesh's
        own names in order, which is what the block carriers run."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        if axes != self.axes:
            raise ValueError(f"axes={axes}: the carriers shard the leading grid axes over the "
                             f"mesh's own axes {self.axes}, in order")
        return axes

    def __repr__(self) -> str:
        tail = "" if self.comm is None else f", owned={self.owned}, {self.comm}"
        return f"Mesh({[str(d) for d in self.devices]}, axis={self.axis!r}, dims={self.dims}{tail})"


def make_mesh(num_devices: Optional[int] = None, axis: str = "x", devices=None) -> Mesh:
    """1-D mesh over the first ``num_devices`` devices (all by default).

    By default the devices are the visible CUDA devices, one shard each;
    asking for more shards than devices raises, as the JAX package does.
    ``devices=`` gives the list explicitly, and may repeat a device
    (``["cuda:0"] * 4``: four shards on one card; ``["cpu"] * 8`` in the CPU
    tests); ``num_devices`` then takes its first entries."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if num_devices is not None:
        if num_devices > len(devices):
            raise ValueError(f"requested {num_devices} devices, have {len(devices)}")
        devices = devices[:num_devices]
    return Mesh(devices, axis)


def _part(v, i: int, device=None):
    """Shard i's view of ``v``: its part of a ``Shards``, a plain tensor (a
    replicated value) on ``device``, anything else as it is; lists and
    tuples element by element."""
    if isinstance(v, Shards):
        return v.parts[i]
    if device is not None and torch.is_tensor(v):
        return v.to(device)
    if isinstance(v, (list, tuple)):
        return type(v)(_part(u, i, device) for u in v)
    return v


def _mesh_of(args):
    for a in args:
        if isinstance(a, Shards):
            return a.mesh
        if isinstance(a, (list, tuple)):
            m = _mesh_of(a)
            if m is not None:
                return m
    return None


class Shards:
    """A row-sharded value: ``parts[k]`` is the part of global shard
    ``mesh.owned[k]`` and lives on ``mesh.local_devices[k]`` (on a mesh of
    one process, ``parts[i]`` on ``mesh.devices[i]``).

    Arithmetic (``+``, ``-``, ``*``, ``/``; ``@`` from the left), ``map``
    and torch functions act shard by shard; operands are
    ``Shards`` of the same mesh, Python numbers, or plain tensors (a
    replicated value, copied to each shard's device).  ``shape``, ``dtype``
    and ``device`` are those of the first part (the parts of a row-sharded
    vector have one shape)."""

    __slots__ = ("parts", "mesh")

    def __init__(self, parts, mesh: Mesh):
        parts = tuple(parts)
        if len(parts) != len(mesh.owned):
            raise ValueError(f"{len(parts)} parts for the {len(mesh.owned)} owned shards of {mesh}")
        self.parts = parts
        self.mesh = mesh

    @staticmethod
    def map(fn: Callable, *args) -> "Shards":
        """``fn`` on each shard's parts of ``args`` (``Shards`` or values
        passed to every shard)."""
        mesh = _mesh_of(args)
        return Shards([fn(*(_part(a, k, d) for a in args))
                       for k, d in enumerate(mesh.local_devices)], mesh)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        """A torch function of ``Shards`` arguments, run on each shard's
        parts: a ``Shards`` of its results (a tuple of ``Shards`` where it
        returns a tuple)."""
        kwargs = kwargs or {}
        mesh = _mesh_of(list(args) + list(kwargs.values()))
        outs = [func(*_part(tuple(args), i, d), **{k: _part(v, i, d) for k, v in kwargs.items()})
                for i, d in enumerate(mesh.local_devices)]
        if isinstance(outs[0], tuple):
            return tuple(Shards([o[j] for o in outs], mesh) for j in range(len(outs[0])))
        return Shards(outs, mesh)

    def _bin(self, other, op):
        return Shards.map(op, self, other)

    def __add__(self, other):
        return self._bin(other, operator.add)

    def __sub__(self, other):
        return self._bin(other, operator.sub)

    def __mul__(self, other):
        return self._bin(other, operator.mul)

    def __rmul__(self, other):
        return Shards.map(operator.mul, other, self)

    def __truediv__(self, other):
        return self._bin(other, operator.truediv)

    def __rmatmul__(self, other: torch.Tensor):
        """``other @ part`` on each shard, ``other`` (a small host-side
        coefficient row, say) copied to each shard's device."""
        return Shards([other.to(p.device) @ p for p in self.parts], self.mesh)

    def __bool__(self):
        raise TypeError("a Shards value has no truth value: read one part (parts[0])")

    def __getitem__(self, idx) -> "Shards":
        """Each part indexed alike: a stacked basis's ``V[k]`` or ``V[:k]``
        (its leading axis is the basis index; the rows stay sharded)."""
        return Shards.map(lambda p: p[idx], self)

    def __setitem__(self, idx, value) -> None:
        """``part[idx] = value``'s part on each shard, in place."""
        for i, p in enumerate(self.parts):
            p[idx] = _part(value, i, p.device)

    def new_zeros(self, shape) -> "Shards":
        """Zeros of ``shape`` (a local shape) on each shard, in its dtype."""
        return Shards.map(lambda p: p.new_zeros(shape), self)

    def numel(self) -> int:
        """The elements of one part (the local size, as ``shape`` is)."""
        return self.parts[0].numel()

    def reshape(self, *shape) -> "Shards":
        return Shards.map(lambda p: p.reshape(*shape), self)

    @property
    def T(self) -> "Shards":
        return Shards.map(lambda p: p.T, self)

    def contiguous(self) -> "Shards":
        return Shards.map(lambda p: p.contiguous(), self)

    def to(self, *args, **kwargs) -> "Shards":
        """Each part's ``.to`` (a dtype cast; a device move would leave the
        mesh)."""
        return Shards.map(lambda p: p.to(*args, **kwargs), self)

    @property
    def shape(self):
        return self.parts[0].shape

    @property
    def dtype(self):
        return self.parts[0].dtype

    @property
    def device(self):
        return self.parts[0].device

    def gather(self, dim=0) -> torch.Tensor:
        """The global value on the first shard's device: row blocks
        concatenated in shard order along ``dim``, or, with a pair of dims
        on a 2-D mesh, blocks concatenated along ``dim[1]`` within each row
        of the mesh and the rows along ``dim[0]``.  On a mesh that spans
        processes a collective: every process gets the global value, on its
        first device."""
        mesh = self.mesh
        dev = mesh.local_devices[0]
        parts = ([p.to(dev) for p in self.parts] if mesh.comm is None
                 else mesh.comm.all_gather_parts(self.parts, dev))
        if isinstance(dim, int):
            return torch.cat(parts, dim=dim)
        per = mesh.dims[1]
        rows = [torch.cat(parts[i:i + per], dim=dim[1]) for i in range(0, len(parts), per)]
        return torch.cat(rows, dim=dim[0])

    def gather_grid(self, d: int) -> torch.Tensor:
        """The global grid of grid blocks whose trailing ``d`` dims are the
        grid (``shard_blocks``'s layout), on the first shard's device."""
        dims = tuple(range(-d, -d + self.mesh.ndim))
        return self.gather(dims[0] if len(dims) == 1 else dims)

    def cpu(self) -> torch.Tensor:
        """The gathered global value on the host."""
        return self.gather().cpu()


def shard_rows(mesh: Mesh, a, dtype=None, dim: int = -1) -> Shards:
    """A global array (numpy or tensor) split into equal row blocks along
    ``dim`` (the last: a vector's rows, a DIA ``data``'s columns), block i
    placed on ``mesh.devices[i]`` as a contiguous tensor of ``dtype``
    (``None``: kept); of a mesh that spans processes, the owned blocks."""
    t = a if torch.is_tensor(a) else torch.as_tensor(a)
    if dtype is not None:
        from conjugategradient_tpu_torch.core.formats import torch_dtype

        dtype = torch_dtype(dtype)
    num = mesh.size
    n = t.shape[dim]
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    blocks = torch.chunk(t, num, dim=dim)
    return Shards([blocks[i].to(device=d, dtype=dtype).contiguous() for i, d in mesh.shards()],
                  mesh)


def shard_blocks(mesh: Mesh, a, dims=(0, 1), dtype=None) -> Shards:
    """A global grid array (numpy or tensor) split into blocks: along
    ``dims[0]`` over a 1-D mesh (``shard_rows``), along ``dims[0]`` and
    ``dims[1]`` over the two axes of a 2-D mesh, block (i, j) on the shard
    at (i, j), each a contiguous tensor of ``dtype`` (``None``: kept); of a
    mesh that spans processes, the owned blocks."""
    t = a if torch.is_tensor(a) else torch.as_tensor(a)
    if dtype is not None:
        from conjugategradient_tpu_torch.core.formats import torch_dtype

        dtype = torch_dtype(dtype)
    blocks = [t]
    for dim, num in zip(tuple(dims), mesh.dims):
        if t.shape[dim] % num:
            raise ValueError(f"extent {t.shape[dim]} of dim {dim} not divisible by {num} shards")
        blocks = [c for blk in blocks for c in torch.chunk(blk, num, dim=dim)]
    return Shards([blocks[i].to(device=d, dtype=dtype).contiguous() for i, d in mesh.shards()],
                  mesh)


def replicate(mesh: Mesh, a, dtype=None) -> Shards:
    """The same value on every owned shard's device (one copy per
    device)."""
    t = a if torch.is_tensor(a) else torch.as_tensor(a)
    return Shards([t.to(device=d, dtype=dtype) for d in mesh.local_devices], mesh)


# ---------------------------------------------------------------------------
# the collectives: the only code that reads another shard's part
# ---------------------------------------------------------------------------


def _combine(x: Shards, fn) -> Shards:
    mesh = x.mesh
    dev = mesh.local_devices[0]
    parts = x.parts if mesh.comm is None else mesh.comm.all_gather_parts(x.parts, dev)
    total = parts[0]
    for p in parts[1:]:
        total = fn(total, p.to(dev))
    return Shards([total.to(d) for d in mesh.local_devices], mesh)


def psum(x: Shards) -> Shards:
    """Sum over every shard of the mesh: the partials added in shard order
    (row-major on a 2-D mesh) on the first shard's device in their dtype,
    the sum on every shard's device.  Across processes every partial is
    gathered and each process adds them all in that order on its first
    device: the same sum, bit for bit."""
    return _combine(x, torch.add)


def pmax(x: Shards) -> Shards:
    """Maximum over every shard of the mesh, on every shard's device."""
    return _combine(x, torch.maximum)


def ppermute(x: Shards, shift: int, axis=None) -> Shards:
    """Cyclic neighbour shift: shard i receives the part of shard
    ``(i - shift) % num`` (``shift=1``: each sends right), copied to its
    device.  ``axis`` (a 2-D mesh's axis name or index) shifts along that
    axis alone: inside each row (axis 1) or each column (axis 0) of the
    mesh.  ``None``: the flat ring of every shard.  Across processes the
    slabs whose receiver another process owns go point to point."""
    mesh = x.mesh
    if axis is None:
        src = [(i - shift) % mesh.size for i in range(mesh.size)]
    else:
        a = mesh.axes.index(axis) if isinstance(axis, str) else int(axis)
        src = []
        for i in range(mesh.size):
            c = list(mesh.coords(i))
            c[a] = (c[a] - shift) % mesh.dims[a]
            src.append(mesh.index(c))
    if mesh.comm is not None:
        return Shards(mesh.comm.ppermute(x.parts, src, mesh.owned, mesh.local_devices), mesh)
    return Shards([x.parts[j].to(d) for j, d in zip(src, mesh.devices)], mesh)


def all_gather(x: Shards, dim: int = 0) -> Shards:
    """Every shard's part concatenated in shard order along ``dim``, on
    every shard's device (``jax.lax.all_gather(..., tiled=True)``)."""
    g = x.gather(dim)
    return Shards([g.to(d) for d in x.mesh.local_devices], x.mesh)


# ---------------------------------------------------------------------------
# the divisibility rule of the GSPMD carriers
# ---------------------------------------------------------------------------


class GridSplit(NamedTuple):
    """How a grid lies on a mesh: ``names[ax]`` is the mesh axis that grid
    axis ``ax`` shards over (``None``: replicated), ``local`` the extent
    one shard holds."""

    names: Tuple[Optional[str], ...]
    local: Tuple[int, ...]

    @property
    def sharded(self) -> bool:
        return any(self.names)


def specs_for_grid(g, mesh: Mesh, axes) -> GridSplit:
    """The JAX package's rule: the leading ``len(axes)`` grid axes that
    divide their mesh axes shard, the others replicate (NamedSharding
    requires even divisibility).  Shared by ``parallel.gspmd`` and
    ``precond.distributed``.  The JAX function returns the
    (data, vector) PartitionSpecs; torch has none, so this returns the
    split they describe (``GridSplit``): the sharded axes, and the local
    extent, which is the global one on every replicated axis."""
    g = tuple(int(n) for n in g)
    names = [ax if g[i] % mesh.shape[ax] == 0 else None for i, ax in enumerate(tuple(axes)[:len(g)])]
    names += [None] * (len(g) - len(names))
    local = tuple(n // mesh.shape[ax] if ax else n for n, ax in zip(g, names))
    return GridSplit(tuple(names), local)
