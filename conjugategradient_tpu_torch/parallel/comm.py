"""The transport of the mesh's collectives between processes.

A ``Communicator`` is a thin object over the default ``torch.distributed``
process group: the rank, the world size and the group's backend, and the
two motions the collectives of ``parallel.mesh`` need across processes:

- ``all_gather_parts``: every process's parts (of one shape), in global
  shard order, on one local device.  ``psum``/``pmax`` add or max them left
  to right on that device, so a sum over processes is the one-process
  mesh's sum bit for bit; ``all_gather`` and ``Shards.gather`` concatenate
  them.
- ``ppermute``: the cyclic shift's slabs between processes, point to point
  (``batch_isend_irecv``, one batch a call), the operations issued in one
  global order (receiver by receiver) on every rank, so the pairs match
  even where a rank's left and right neighbour are the same rank.

The backend is the group's: NCCL moves CUDA tensors (one rank a GPU; NCCL
refuses two ranks on one GPU), Gloo moves CPU tensors.  Gloo with CUDA
parts, which only a caller who names ``backend="gloo"`` gets, stages each
transfer through host buffers here and nowhere else (``_staged``): that is
how two ranks share one card.  Nothing switches from NCCL to Gloo on its
own, and no part leaves its device for a computation.

``seconds`` is the host time spent inside the communicator's calls (on the
staged route after the device has finished the work queued before the
call, so it is the transport's own), ``calls`` the number of them.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch


class Communicator:
    """The default process group, as the mesh's collectives use it."""

    def __init__(self):
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError("no process group: call parallel.multihost.initialize_distributed "
                               "first")
        self._dist = dist
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.backend = str(dist.get_backend())
        self.seconds = 0.0
        self.calls = 0

    def __repr__(self) -> str:
        return f"Communicator(rank={self.rank}, world={self.world}, backend={self.backend!r})"

    def _staged(self, device: torch.device) -> bool:
        """Whether tensors on ``device`` go through host buffers: CUDA parts
        under Gloo.  CPU parts under NCCL cannot move at all."""
        if self.backend == "gloo":
            return device.type != "cpu"
        if device.type != "cuda":
            raise ValueError(f"the {self.backend} backend moves CUDA tensors, not {device} parts: "
                             "initialize_distributed(backend='gloo') for CPU parts")
        return False

    def _begin(self, device: torch.device) -> float:
        if device.type == "cuda" and self._staged(device):
            torch.cuda.synchronize(device)  # the queued work is not the transport's
        return time.perf_counter()

    def _end(self, t0: float) -> None:
        self.seconds += time.perf_counter() - t0
        self.calls += 1

    def all_gather_parts(self, parts: Sequence[torch.Tensor],
                         device: torch.device) -> List[torch.Tensor]:
        """Every rank's ``parts`` (this rank's owned parts, all of one shape
        and dtype, as every rank's are) on ``device``, in global shard order:
        rank 0's, then rank 1's, ..."""
        t0 = self._begin(device)
        mine = torch.stack([p.to(device) for p in parts])
        staged = self._staged(device)
        send = mine.cpu() if staged else mine.contiguous()
        out = [torch.empty_like(send) for _ in range(self.world)]
        self._dist.all_gather(out, send)
        if staged:
            out = [o.to(device) for o in out]
        self._end(t0)
        return [t for o in out for t in o.unbind(0)]

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, by rank (setup metadata: the
        devices each rank contributes to a mesh)."""
        out = [None] * self.world
        self._dist.all_gather_object(out, obj)
        return out

    def ppermute(self, parts: Sequence[torch.Tensor], src: Sequence[int], owned: range,
                 devices: Sequence[torch.device]) -> List[torch.Tensor]:
        """The cyclic shift across processes: global shard i (for each i in
        ``owned``, on ``devices[i - owned.start]``) receives the part of
        shard ``src[i]``.  Sources this rank owns are device copies; the
        others arrive point to point from their owners, which send them in
        the same global order.  Every rank's parts have one shape and
        dtype (the receive buffers take this rank's)."""
        dist = self._dist
        per = len(owned)
        owner = lambda i: i // per  # noqa: E731
        dev0 = devices[0]
        t0 = self._begin(dev0)
        staged = self._staged(dev0)
        like = parts[0]
        out = {}
        ops, recvs = [], []
        for i, j in enumerate(src):  # receiver by receiver, one global order
            mine_i, mine_j = i in owned, j in owned
            if mine_i and mine_j:
                out[i] = parts[j - owned.start].to(devices[i - owned.start])
            elif mine_j:
                t = parts[j - owned.start]
                t = t.cpu() if staged else t.contiguous()
                ops.append(dist.P2POp(dist.isend, t, owner(i), tag=i))
            elif mine_i:
                buf = torch.empty(like.shape, dtype=like.dtype,
                                  device="cpu" if staged else devices[i - owned.start])
                ops.append(dist.P2POp(dist.irecv, buf, owner(j), tag=i))
                recvs.append((i, buf))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        for i, buf in recvs:
            out[i] = buf.to(devices[i - owned.start])
        self._end(t0)
        return [out[i] for i in owned]
