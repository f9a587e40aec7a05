"""Design constants of kernel #5 (the DIA SpMM), measured on the card.

    python -m conjugategradient_tpu_torch.scripts.dia_tuning

Builds ``csrc/dia.cu`` once for each value of its compile-time design
constants (``nvcc -D``; all builds started together):

- ``SPMM_SPAN``: the widest leg span whose X window a block stages in
  shared memory (0: every X read goes through L1);
- ``SPMM_STAGE_BYTES``: the least X bytes a leg reads per row (K times the
  column type's size) for which the window is staged (it is staged too
  where those bytes are eight times the leg's own);
- ``SPMM_LEGS``: the coefficients per batch of each row's stream for fp32
  legs, up to four columns and more than that many legs (two batches are
  in flight per thread); ``SPMM_LEGS_SHORT``: the batch otherwise;
- ``SPMM_THREADS``: rows per block;
- ``SPMM_STAGE_MINB``: blocks per SM asked of ``ptxas`` for the staged form
  (a register cap).

Prints each build's ``ptxas`` lines for kernel #5, each with the blocks an
SM holds at its register count (``blocks_per_sm``) and the waves that makes
of the flagship's grid, and times it with CUDA events after a warm-up at
the main path's shapes: the flagship band 160 (n = 207,402) at k = 4 in
fp32, bf16 legs and fp64, at k = 8 and k = 1 in fp32 (beside kernel #4's
SpMV), and the 255^3 operator as a 7-diagonal DIA (offsets +-1, +-255,
+-65025, random legs) at k = 4 in fp32.  Each time
stands beside its bound (each leg entry whose neighbour lies in the matrix
read once, X read once, Y written once, at 3.35 TB/s).

Every variant is held to the twin first (max error <= 1e-5 of max |twin|,
1e-13 in fp64).  The launches go through the wrapper's launch helper, not
the wrapper, so kernel #5's launch counts do not move.  The last line is
one JSON record: ``{"card": ..., "spmm_dia": {variant: {shape: ms}},
"spmv_dia": {shape: ms}}``.  Needs a CUDA device.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import sys

import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.ops import cuda_dia as cd
from conjugategradient_tpu_torch.ops.card import bound_ms, card_name, dia_nnz, time_ms

REL, REL64 = 1e-5, 1e-13
#: build label -> -D overrides; the first is the shipped design
BUILDS = {
    "SPMM_SPAN=1024 SPMM_STAGE_BYTES=32 SPMM_STAGE_MINB=4 SPMM_LEGS=16 SPMM_LEGS_SHORT=8 "
    "SPMM_THREADS=256": (),
    "SPMM_SPAN=0": ("SPMM_SPAN=0",),
    "SPMM_STAGE_BYTES=4": ("SPMM_STAGE_BYTES=4",),
    "SPMM_STAGE_BYTES=16": ("SPMM_STAGE_BYTES=16",),
    "SPMM_STAGE_MINB=2": ("SPMM_STAGE_MINB=2",),
    "SPMM_LEGS=4": ("SPMM_LEGS=4",),
    "SPMM_LEGS=8": ("SPMM_LEGS=8",),
    "SPMM_LEGS=12": ("SPMM_LEGS=12",),
    "SPMM_LEGS=24": ("SPMM_LEGS=24",),
    "SPMM_LEGS_SHORT=4": ("SPMM_LEGS_SHORT=4",),
    "SPMM_THREADS=128": ("SPMM_THREADS=128",),
    "SPMM_THREADS=64": ("SPMM_THREADS=64",),
}
#: the H100's per-SM limits: registers, threads, blocks; and its SMs
SM_REGS, SM_THREADS, SM_BLOCKS, SMS = 65536, 2048, 32, 132
FLAGSHIP_N = 207_402


def blocks_per_sm(registers: int, threads: int) -> int:
    """Blocks of ``threads`` threads an SM holds at ``registers`` per thread
    (allocated per warp in units of 256), without shared memory."""
    warps = -(-threads // 32)
    per_warp = -(-registers * 32 // 256) * 256
    return min(SM_REGS // per_warp // warps, SM_THREADS // threads, SM_BLOCKS)


def _threads(defines) -> int:
    return next((int(d.split("=")[1]) for d in defines if d.startswith("SPMM_THREADS=")), 256)


def _cases(dev):
    """(label, device DiaMatrix, X) of the timed shapes."""
    band = generators.banded_sin_matrix(FLAGSHIP_N, 160)
    g = torch.Generator(device=dev).manual_seed(0)
    for legs, k in ((torch.float32, 4), (torch.bfloat16, 4), (torch.float64, 4), (torch.float32, 8),
                    (torch.float32, 1)):
        A = band.device_put(legs, dev)
        vec = torch.float64 if legs == torch.float64 else torch.float32
        yield f"band 160 k={k} {cd.TAGS[legs]}", A, torch.randn((k, A.n), generator=g, device=dev).to(vec)
    n, p = 255**3, 255**2
    offsets = (-p, -255, -1, 0, 1, 255, p)
    A = DiaMatrix(torch.rand((7, n), generator=g, device=dev), offsets, (n, n))
    yield "255^3 7 diagonals k=4 fp32", A, torch.randn((4, n), generator=g, device=dev)


def main() -> int:
    if not torch.cuda.is_available():
        print("dia_tuning: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_name()
    print(card)
    with cf.ThreadPoolExecutor(len(BUILDS)) as pool:
        list(pool.map(lambda d: _build.build(["dia"], d), BUILDS.values()))
    for label, defines in BUILDS.items():
        for entry, res in sorted(_build.kernel_resources("dia", defines).items()):
            if "spmm_dia_kernel" in entry:
                t = _threads(defines)
                per_sm = blocks_per_sm(res["registers"], t)
                waves = -(-FLAGSHIP_N // t) / (SMS * per_sm)
                print(f"ptxas dia [{label}] {entry[:60]}: {res}; {per_sm} blocks/SM, "
                      f"{waves:.2f} waves at n = {FLAGSHIP_N}")
    record = {"card": card, "spmm_dia": {label: {} for label in BUILDS}}
    for shape, A, X in _cases(dev):
        code = cd._CODES[(A.data.dtype, X.dtype)]
        ref = cd.spmm_dia_ref(A, X)
        scale = float(ref.abs().max())
        nbytes = dia_nnz(A) * A.data.element_size() + 2 * X.numel() * X.element_size()
        bound = bound_ms(nbytes, 2 * X.shape[0] * dia_nnz(A))[0]
        for label, defines in BUILDS.items():
            lib = _build.load("dia", defines)
            fn = lambda: cd._spmm_launch(lib, code, A, X)
            err = float((fn() - ref).abs().max())
            rel = REL64 if X.dtype == torch.float64 else REL
            if not err <= rel * scale:
                raise RuntimeError(f"spmm_dia [{label}] {shape}: max err {err:.3e} > {rel}*{scale:.3e}")
            ms = time_ms(fn, 100)
            record["spmm_dia"][label][shape] = ms
            print(f"time spmm_dia [{label}] {shape}: {ms:.4f} ms (bound {bound:.4f} ms of "
                  f"{nbytes / 1e6:.1f} MB, {bound / ms:.1%} of it) [{card}]")
        if X.shape[0] == 1:
            ms = time_ms(lambda: cd.spmv_dia_cuda(A, X[0]), 100)
            record["spmv_dia"] = {shape: ms}
            print(f"time spmv_dia (kernel #4) {shape}: {ms:.4f} ms [{card}]")
        del ref
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
