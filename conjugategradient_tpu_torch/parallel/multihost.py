"""Global meshes and per-block assembly: the single-process half of
``conjugategradient_tpu/parallel/multihost.py``.

The JAX package's multi-host path is process-group initialisation plus a
mesh over the global devices; its SPMD programs then span hosts unchanged.
The port's collectives (``parallel.mesh``) run in one process, over the
devices it sees: ``initialize_distributed`` is a no-op there, as it is for
the JAX package solo, and raises when asked to join a process group, which
comes with a communicator over ``torch.distributed`` (ROADMAP queue 1:
parallel, item 6b).

``make_distributed_system`` assembles a named workload shard by shard from
``Workload.build_rows``: each shard's row block is generated on the host and
placed on its device, so the global system never exists in host memory.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, torch_dtype
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards, make_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    strict: bool = False,
) -> None:
    """Join the process group: a no-op for a single process.  Coordination
    arguments (or ``strict=True``) ask for a multi-process run, which the
    port does not have yet: that raises ``NotImplementedError``."""
    if strict or any(v is not None for v in (coordinator_address, num_processes, process_id)):
        raise NotImplementedError(
            "multi-process meshes are not ported yet (ROADMAP queue 1: parallel, item 6b: a "
            "torch.distributed communicator)")


def global_mesh(axis: str = "x", devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over every device this process sees (every visible CUDA
    device), or over ``devices``."""
    return make_mesh(axis=axis, devices=devices)


def host_count() -> int:
    """The processes of the run: 1."""
    return 1


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
    for i, dev in enumerate(mesh.devices):
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
