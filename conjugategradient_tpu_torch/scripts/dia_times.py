"""Kernels #4 and #5 timed at the flagship's shape, to compare checkouts on
one card.

    PYTHONPATH=<checkout> python <this file> <tag>

Imports ``conjugategradient_tpu_torch`` from wherever ``PYTHONPATH`` points,
so one copy of this file times any checkout of the port: it calls only
``WORKLOADS["cublas_flagship"]`` (n = 207,402, band 160), ``DiaMatrix.
device_put`` and the wrappers ``spmv_dia_cuda``, ``spmv_dot_dia_cuda`` and
``spmm_dia_cuda``.  Times each with CUDA events after a warm-up
(``ops.card.time_ms``): the SpMV with fp32, bf16 and fp64 legs, the fused
p·Ap with fp32 legs, the SpMM at k = 4 (and k = 8 with fp32 legs).  Prints
one line: the tag, the package's path and the times in ms.  Run it as
parent, change, change, parent in one call to compare two checkouts.
Needs a CUDA device.
"""

import sys

import numpy as np
import torch

import conjugategradient_tpu_torch
from conjugategradient_tpu_torch.models.workloads import WORKLOADS
from conjugategradient_tpu_torch.ops.card import time_ms
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_cuda, spmv_dia_cuda, spmv_dot_dia_cuda


def main(tag: str) -> None:
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
    print(tag, conjugategradient_tpu_torch.__file__, {k: round(v, 5) for k, v in out.items()})


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "checkout")
