"""Kernel #6, the single-call accumulating DIA SpMM, against kernel #5.

The port of the JAX package's ``scripts/spmm_acc_experiment.py``.  There one
Pallas call with a sequential diagonal-group axis, the output block resident
across it, ran slower than the chained per-group calls of the library path,
and was kept as a negative result.  On Hopper the sequential axis is a loop
inside the block: kernel #6 (``ops.cuda_dia.spmm_dia_acc_cuda``) copies each
group's window of X into a ring of shared-memory buffers ahead of its sums,
streams the coefficients in batches that run across the groups, and keeps
Y in registers across them.  This module measures it anew.

    python -m conjugategradient_tpu_torch.scripts.spmm_acc_experiment [--cpu] [--n N] [--band B] [--k K]

defaults n = 414,720, band 160, k = 8 (the JAX script's).  It builds
``banded_sin_matrix(n, band)`` in fp32, checks kernel #6 column by column
against the fp64 oracle (max relative error under 1e-5, the JAX script's
assertion), times it against the library path with CUDA events over many
launches after a warm-up (the fp32 matrix, 264 MB at the defaults, exceeds
the 50 MB L2, so every launch reads it from device memory), and prints one
JSON record with the JAX script's keys:

- ``chained_us``: the library path.  On the card that is kernel #5
  (``ops.cuda_dia.spmm_dia_cuda``, which every multi-RHS solve of the port
  runs), standing where the JAX script's chained per-group calls stood;
- ``single_call_us``: kernel #6;
- ``chained_over_single_x``: ``single_call_us / chained_us``, computed as the
  JAX script computes it (above 1: the single call is slower);
- ``max_rel_err``, ``experiment``, ``platform``, ``n``, ``k``;

plus ``bound_us``, the least time the card could take (``ops.card.bound_ms``:
the bytes the product must move at the H100's published 3.35 TB/s, or its
fp32 operations at 67 TFLOP/s, whichever is longer), and ``card``, the
card's name and power limit as ``nvidia-smi`` prints them.  ``run`` is the
experiment without the command line: ``chip_smoke.py`` calls it and keeps
its record.

``--cpu`` runs the kernel's plain twin on the CPU to check the arithmetic and
prints no time.  Without it the run needs a CUDA device and fails without
one.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops.card import bound_ms, card_name, dia_nnz, spmm_bytes, time_ms
from conjugategradient_tpu_torch.ops.cuda_dia import spmm_dia_acc_cuda, spmm_dia_cuda

#: the JAX script's bound on kernel #6 against the fp64 oracle
MAX_REL_ERR = 1e-5


def measure(A_host: DiaMatrix, k: int, device, reps: int = 100, seed: int = 0) -> dict:
    """Check kernel #6 on ``A_host`` (its fp32 legs) with k seeded normal
    columns against the fp64 oracle; on a CUDA device also time it against
    kernel #5.  Returns the record."""
    device = torch.device(device)
    A = A_host.device_put(torch.float32, device)
    X_h = np.random.default_rng(seed).standard_normal((A.n, k)).astype(np.float32)
    X = torch.from_numpy(np.ascontiguousarray(X_h.T)).to(device)
    Y = spmm_dia_acc_cuda(A, X).cpu().numpy()
    err = 0.0
    for j in range(k):
        yo = oracle.spmv(A_host, X_h[:, j].astype(np.float64))
        err = max(err, float(np.abs(Y[j] - yo).max() / np.abs(yo).max()))
    rec = dict(experiment="spmm_acc_single_call", platform=device.type.replace("cuda", "gpu"),
               n=A.n, k=k, max_rel_err=err)
    if device.type == "cuda":
        chained = time_ms(lambda: spmm_dia_cuda(A, X), reps) * 1e3
        single = time_ms(lambda: spmm_dia_acc_cuda(A, X), reps) * 1e3
        bound = bound_ms(spmm_bytes(A, k), 2 * k * dia_nnz(A))[0] * 1e3
        rec.update(chained_us=chained, single_call_us=single, chained_over_single_x=single / chained,
                   bound_us=bound, card=card_name())
    return rec


def run(n: int = 414_720, band: int = 160, k: int = 8, device="cuda") -> dict:
    """The experiment: ``measure`` on ``banded_sin_matrix(n, band)`` in
    fp32; prints the record and returns it."""
    A = generators.banded_sin_matrix(n, band, dtype=np.float32)
    rec = measure(A, k, device)
    print(json.dumps(rec))
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true", help="run the twin on the CPU; no times")
    ap.add_argument("--n", type=int, default=414_720)
    ap.add_argument("--band", type=int, default=160)
    ap.add_argument("--k", type=int, default=8)
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("spmm_acc_experiment: no CUDA device (use --cpu to check the twin)", file=sys.stderr)
        return 2
    rec = run(args.n, args.band, args.k, "cpu" if args.cpu else "cuda")
    if not rec["max_rel_err"] < MAX_REL_ERR:
        print(f"spmm_acc_experiment: max relative error {rec['max_rel_err']:.3e} >= {MAX_REL_ERR}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
