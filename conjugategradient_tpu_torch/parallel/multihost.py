"""Process groups, global meshes and per-block assembly: the port of
``conjugategradient_tpu/parallel/multihost.py``.

The JAX package's multi-host path is process-group initialisation plus a
mesh over the global devices; its SPMD programs then span hosts unchanged.
Here ``initialize_distributed`` joins a ``torch.distributed`` process group
(``tcp://`` rendezvous at the coordinator), ``global_mesh`` builds a
``parallel.mesh.Mesh`` over every process's devices, with a
``parallel.comm.Communicator`` behind its collectives, and the solvers run
unchanged on each process's own shards.  Solo, ``initialize_distributed`` is
a no-op and ``global_mesh`` the local mesh, as they are for the JAX package.

The backend is what ``jax.distributed`` picks on its own: NCCL for CUDA
parts, Gloo on the CPU.  ``backend="gloo"`` with CUDA parts stages every
transfer through host buffers (``parallel.comm``); that is how two ranks
share one GPU, which NCCL refuses ("Duplicate GPU detected").

``make_distributed_system`` assembles a named workload shard by shard from
``Workload.build_rows``: each owned shard's row block is generated on the
host and placed on its device, so the global system never exists in host
memory, and a process generates only its own blocks.
"""

from __future__ import annotations

import datetime
import os
import socket
import warnings
from typing import Optional, Sequence

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, torch_dtype
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, make_mesh

#: the rendezvous's and every collective's time limit, seconds: a peer that
#: died makes the others fail instead of waiting for ever
TIMEOUT_S = 600.0

_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() else None


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    strict: bool = False,
    backend: Optional[str] = None,
    timeout: float = TIMEOUT_S,
) -> None:
    """Join the process group (a no-op if already joined, or solo).

    ``coordinator_address`` (``host:port``, rank 0 listens there),
    ``num_processes`` and ``process_id`` name the group; without them they
    come from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/
    ``RANK``, as JAX detects a pod, and without all four of them the run
    is solo and this returns (under ``strict=True`` it raises).
    ``backend`` defaults to ``"nccl"`` where CUDA is available and
    ``"gloo"`` elsewhere; ``timeout`` (seconds) bounds the
    rendezvous and every collective.  A second call is harmless.  A failure
    re-raises when any coordination argument was given or ``strict=True``
    (a silent fallback would run the whole job 1/N-sized); otherwise it
    warns and the run goes on solo."""
    dist = _dist()
    explicit = any(v is not None for v in (coordinator_address, num_processes, process_id))
    if dist is not None and dist.is_initialized():
        return  # double initialisation: harmless
    try:
        if dist is None:
            raise RuntimeError("torch.distributed is not available in this build of torch")
        env = os.environ
        if not explicit and not all(k in env for k in _ENV):
            if strict:
                raise RuntimeError(f"strict=True, but no coordinator given and none of {_ENV} "
                                   "set to detect one")
            return  # solo
        if coordinator_address is None:
            coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"] if num_processes is None else num_processes)
        process_id = int(env["RANK"] if process_id is None else process_id)
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id,
                                timeout=datetime.timedelta(seconds=timeout))
    except (RuntimeError, ValueError, KeyError, OSError) as e:
        if strict or explicit:
            raise
        warnings.warn(f"torch.distributed unavailable ({e}); continuing single-process")


def host_count() -> int:
    """The processes of the run (1 solo)."""
    dist = _dist()
    return dist.get_world_size() if dist is not None and dist.is_initialized() else 1


def _own_devices(comm, devices):
    """This process's devices: ``devices``, or ``cuda:<local rank>`` where
    several ranks share this host, or every visible CUDA device where this
    process is its host's only rank."""
    if devices is not None:
        return [torch.device(d) for d in devices]
    if comm.backend == "nccl":  # the object collective's staging device
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    hosts = comm.all_gather_object(socket.gethostname())
    here = [r for r, h in enumerate(hosts) if h == hosts[comm.rank]]
    if len(here) > 1:
        return [torch.device("cuda", here.index(comm.rank))]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def global_mesh(axis: str = "x", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every process's devices, rank by rank.

    This process contributes ``devices`` (it may repeat one:
    ``["cuda:0"] * 2``, two shards on the card), or by default
    ``cuda:<local rank>`` where several ranks share the host, or every
    visible CUDA device where it is the host's only rank.  The ranks must
    contribute equally many (raises otherwise).  Solo, the local mesh
    (``make_mesh``)."""
    dist = _dist()
    if dist is None or not dist.is_initialized():
        return make_mesh(axis=axis, devices=devices)
    from conjugategradient_tpu_torch.parallel.comm import Communicator

    comm = Communicator()
    own = _own_devices(comm, devices)
    if not own:
        raise ValueError(f"rank {comm.rank} has no device to contribute to the mesh")
    if comm.backend == "nccl":
        torch.cuda.set_device(own[0])
    every = comm.all_gather_object([str(d) for d in own])
    counts = [len(e) for e in every]
    if len(set(counts)) != 1:
        raise ValueError(f"the ranks contribute unequal device counts {counts}")
    every[comm.rank] = own
    return Mesh([d for e in every for d in e], axis, comm=comm)


def make_distributed_system(workload_name: str, mesh: Mesh, axis: str = "x", dtype=None,
                            pad_multiple: Optional[int] = None):
    """Build a named workload directly into row-sharded device tensors.

    Each shard's rows come from ``Workload.build_rows`` (closed forms in the
    row index) and go to the shard's device.  Rows are identity-padded to a
    multiple of ``pad_multiple`` (default: the shard count) as
    ``core.partition.pad_system`` pads them: ``A[i, i] = 1``, ``b = x0 = 0``,
    no coupling, so the solution's first ``n`` entries are exact.

    Returns ``(A, b, x0, n)``: ``A`` a ``DiaMatrix`` whose ``data`` is the
    ``Shards`` of (ndiags, n_local) blocks (offsets and shape host metadata),
    ``b`` and ``x0`` ``Shards``, ``n`` the unpadded row count."""
    from conjugategradient_tpu_torch.models import get

    w = get(workload_name)
    n = w.size
    num = mesh.shape[axis]
    mult = pad_multiple or num
    n_pad = -(-n // mult) * mult
    if n_pad % num:
        raise ValueError(f"{n_pad} padded rows do not split into {num} shards")
    n_local = n_pad // num
    dt = np.dtype(dtype or np.float64)
    offsets = tuple(w.build_rows(0, 1, dtype=dt)[0])
    diag_k = offsets.index(0)
    tdt = torch_dtype(dt)
    parts = []
    for i, dev in mesh.shards():
        lo, hi = i * n_local, (i + 1) * n_local
        hi_real = min(hi, n)
        d = np.zeros((len(offsets), n_local), dt)
        b_blk = np.zeros(n_local, dt)
        x0_blk = np.zeros(n_local, dt)
        if hi_real > lo:
            _, d[:, :hi_real - lo], b_blk[:hi_real - lo], x0_blk[:hi_real - lo] = w.build_rows(
                lo, hi_real, dtype=dt)
        d[diag_k, max(hi_real - lo, 0):] = 1.0
        parts.append(tuple(torch.from_numpy(a).to(dev, tdt) for a in (d, b_blk, x0_blk)))
    data, b, x0 = (Shards([p[j] for p in parts], mesh) for j in range(3))
    return DiaMatrix(data, offsets, (n_pad, n_pad)), b, x0, n
