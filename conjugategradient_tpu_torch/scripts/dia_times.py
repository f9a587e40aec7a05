"""Kernels #4 and #5 timed at the flagship's shape and past 256 diagonals, to
compare checkouts on one card.

    PYTHONPATH=<checkout> python <this file> <tag>

Imports ``conjugategradient_tpu_torch`` from wherever ``PYTHONPATH`` points,
so one copy of this file times any checkout of the port: it calls only
``WORKLOADS["cublas_flagship"]`` (n = 207,402, band 160), ``DiaMatrix`` and
its ``device_put``, ``ops.card``'s ``time_ms`` and ``graph_ms`` and the
wrappers ``spmv_dia_cuda``, ``spmv_dot_dia_cuda`` and ``spmm_dia_cuda``.
Times each with CUDA events after a warm-up.  The flagship as launched
(``time_ms``): the SpMV with fp32, bf16 and fp64 legs, the fused p·Ap with
fp32 legs, the SpMM at k = 4 (and k = 8 with fp32 legs).  Past 256
diagonals, replayed from a CUDA graph (``graph_ms``): random legs on the
7^3 and 11^3 boxes of a stencil on 16^3 folded into DIA offsets (343 and
1331 diagonals, the 16^3 levels of the 128^3 and 256^3 DIA-layout
hierarchies), fp32 and fp64: the SpMV, the fused p·Ap and the SpMM at
k = 4.  With ``--mgcg``, also the 128^3 Poisson MGCG over its DIA-layout
Galerkin hierarchy (``api.solve(method="mgcg", layout="dia")``, fp32,
rel_l2 1e-6, levels of 7, 81, 125 and 343 diagonals): iterations, the warm
wall (host clock) and the device time of one solve (``torch.profiler``).
Prints one line: the tag, the package's path and the times in ms, then one
line per kernel entry of the checkout's ``dia`` build that ``ptxas``
reported (registers, stack frame, spill bytes; ``ops._build.
kernel_resources``).  Run it as parent, change, change, parent in one call
to compare two checkouts.  Needs a CUDA device.
"""

import itertools
import sys
import time

import numpy as np
import torch

import conjugategradient_tpu_torch
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.models.workloads import WORKLOADS
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.ops.card import graph_ms, time_ms
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda, spmv_dia_cuda, spmv_dot_dia_cuda

#: past 256 diagonals: (label, side of the cube, stencil halo)
MANY = (("16^3 x 343", 16, 3), ("16^3 x 1331", 16, 5))


def box_dia(side, h):
    """A host fp64 DIA matrix: the (2h + 1)^3 box of a stencil on side^3
    folded into flat offsets, random legs (seed 0), entries whose neighbour
    leaves [0, n) zero."""
    n = side ** 3
    box = itertools.product(range(-h, h + 1), repeat=3)
    offs = sorted({(a * side + b) * side + c for a, b, c in box})
    data = np.random.default_rng(0).standard_normal((len(offs), n))
    i = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    return DiaMatrix(data, tuple(offs), (n, n))


def _dia_mgcg(dev):
    """(iterations, warm wall ms, device ms) of the 128^3 DIA-layout MGCG."""
    from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy

    g = (128, 128, 128)
    s = generators.poisson_system(g)
    h = build_hierarchy(s.A, g, dtype=np.float32, device=dev, layout="dia")
    kw = dict(method="mgcg", grid=g, tol=1e-6, norm="rel_l2", dtype=np.float32, device=dev,
              precise_dot=True, hierarchy=h, layout="dia")
    res = api.solve(s.A, s.b, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.solve(s.A, s.b, **kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        api.solve(s.A, s.b, **kw)
        torch.cuda.synchronize()
    dev_us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    return res.iterations, wall, dev_us / 1e3


def main(tag: str, mgcg: bool = False) -> None:
    fs = WORKLOADS["cublas_flagship"].build(dtype=np.float64)
    dev = torch.device("cuda")
    out = {}
    for legs in (torch.float32, torch.bfloat16, torch.float64):
        A = fs.A.device_put(legs, dev)
        vec = torch.float64 if legs == torch.float64 else torch.float32
        x = torch.randn(fs.n, device=dev, dtype=vec)
        out[f"spmv {legs}"] = time_ms(lambda: spmv_dia_cuda(A, x), 400)
        if legs == torch.float32:
            out["spmv_dot fp32"] = time_ms(lambda: spmv_dot_dia_cuda(A, x), 400)
        for k in ((4, 8) if legs == torch.float32 else (4,)):
            X = torch.randn(k, fs.n, device=dev, dtype=vec)
            out[f"spmm {legs} k={k}"] = time_ms(lambda: spmm_dia_cuda(A, X), 200)
    for label, side, h in MANY:
        A_host = box_dia(side, h)
        for legs in (torch.float32, torch.float64):
            A = A_host.device_put(legs, dev)
            x = torch.randn(A.n, device=dev, dtype=legs)
            X = torch.randn(4, A.n, device=dev, dtype=legs)
            name = "fp32" if legs == torch.float32 else "fp64"
            out[f"{label} spmv {name} (graph)"] = graph_ms(lambda: spmv_dia_cuda(A, x), 200)
            out[f"{label} spmv_dot {name} (graph)"] = graph_ms(lambda: spmv_dot_dia_cuda(A, x), 200)
            out[f"{label} spmm {name} k=4 (graph)"] = graph_ms(lambda: spmm_dia_cuda(A, X), 100)
    if mgcg:
        its, wall, dev_ms = _dia_mgcg(dev)
        out.update({"128^3 DIA MGCG iterations": its, "128^3 DIA MGCG warm wall": wall,
                    "128^3 DIA MGCG device": dev_ms})
    print(tag, conjugategradient_tpu_torch.__file__, {k: round(v, 5) for k, v in out.items()})
    for entry, res in sorted(_build.kernel_resources("dia").items()):
        print(tag, "ptxas", entry, res)


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--mgcg"]
    main(args[0] if args else "checkout", "--mgcg" in sys.argv[1:])
