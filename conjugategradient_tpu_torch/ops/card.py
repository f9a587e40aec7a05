"""The card's published peaks and per-SM limits, the least time a kernel could
take on it, and CUDA-event timing (of launches from the host, or replayed from a CUDA
graph): what ``chip_smoke.py``, the tuning scripts and the kernel #6
experiment (``scripts/spmm_acc_experiment.py``) report each kernel against.

Nothing on a solve path imports this module.
"""

from __future__ import annotations

import subprocess
from typing import Tuple

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops.cuda_dia import _windows

#: the H100 SXM's published device-memory rate (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
#: the H100 SXM's published fp32 rate outside the tensor cores (700 W)
FP32_FLOPS = 67e12
#: the H100's SMs and per-SM limits: registers, threads, blocks, shared
#: memory (bytes; each block also holds 1 KB of it for the system)
SMS, SM_REGS, SM_THREADS, SM_BLOCKS, SM_SMEM = 132, 65536, 2048, 32, 228 * 1024


def blocks_per_sm(registers: int, threads: int, smem_bytes: int = 0) -> int:
    """Blocks of ``threads`` threads an SM holds at ``registers`` per thread
    (allocated per warp in units of 256) and ``smem_bytes`` of shared
    memory per block."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    by_smem = SM_SMEM // (smem_bytes + 1024) if smem_bytes else SM_BLOCKS
    return min(SM_REGS // per_warp // warps, SM_THREADS // threads, SM_BLOCKS, by_smem)


def bound_ms(nbytes: float, flops: float) -> Tuple[float, str]:
    """(ms, ``"bytes"`` or ``"operations"``): the longer of ``nbytes`` at
    HBM_BYTES_PER_S and ``flops`` fp32 operations at FP32_FLOPS."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def dia_nnz(A: DiaMatrix) -> int:
    """Leg entries whose neighbour lies inside the matrix: the entries a DIA
    kernel reads."""
    return sum(i1 - i0 for _, _, i0, i1 in _windows(A))


def dia_csr(A: DiaMatrix) -> torch.Tensor:
    """A device DIA matrix as a CSR tensor with int32 indices, built on the
    card, for timing cuSPARSE's product beside a kernel: each row's in-range
    entries, offsets ascending."""
    n = A.n
    order = sorted(range(A.ndiags), key=lambda k: A.offsets[k])
    offs = torch.tensor([A.offsets[k] for k in order], device=A.data.device)
    cols = torch.arange(n, device=offs.device)[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=offs.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), A.data[order].T[keep], size=(n, n),
                                   check_invariants=False)


def spmm_bytes(A: DiaMatrix, k: int) -> int:
    """Bytes that Y = A X must move for k fp32 columns: each leg entry whose
    neighbour lies inside the matrix read once, X read once, Y written once."""
    return dia_nnz(A) * A.data.dtype.itemsize + 2 * k * A.n * 4


def time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` by CUDA events over ``reps`` calls after a
    warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` replayed from one CUDA graph of ``reps``
    calls, by CUDA events: the device time of a kernel too short for the
    host to launch it as fast as the card runs it (``time_ms`` then reads
    the host's launch rate)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_name() -> str:
    """The card's name and power limit, as ``nvidia-smi`` prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
