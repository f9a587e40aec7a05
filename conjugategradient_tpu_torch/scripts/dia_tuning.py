"""Design constants of kernels #5 and #6 (the DIA SpMMs) and the split form
of #4 and #5 past 256 diagonals, measured on the card.

    python -m conjugategradient_tpu_torch.scripts.dia_tuning

Builds ``csrc/dia.cu`` once for each value of its compile-time design
constants (``nvcc -D``; all builds started together).  Kernel #5:

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

Kernel #6 (the single-call accumulating SpMM):

- ``ACC_TILE``: rows per block;
- ``ACC_LEGS``: the coefficients per batch of each row's stream;
- ``ACC_STAGES``: the window buffers in the ring (the copies of that many
  groups less one are in flight while a group is summed; 2 is double
  buffering).

Prints each build's ``ptxas`` lines for the kernel it tunes, each with the
blocks an SM holds at its register count (and, for #6, its shared memory
at the main shape) and the waves that makes of the main shape's grid
(#5: the flagship, n = 207,402; #6: n = 414,720, band 160, k = 8), and
times it with CUDA events after a warm-up.  #5 at the main path's shapes:
the flagship band 160 at k = 4 in fp32, bf16 legs and fp64, at k = 8 and
k = 1 in fp32 (beside kernel #4's SpMV), and the 255^3 operator as a
7-diagonal DIA (offsets +-1, +-255, +-65025, random legs) at k = 4 in fp32.
#6 at its experiment's shape (n = 414,720, band 160, k = 8) with fp32 and
bf16 legs, at the flagship k = 4 and on the 255^3 7-diagonal DIA at k = 4,
each beside #5's shipped build on the same inputs.  Each time stands beside
its bound (each leg entry whose neighbour lies in the matrix read once, X
read once, Y written once, at 3.35 TB/s).

The split form of kernels #4 and #5 past 256 diagonals (``--split``
runs only this part): each build of ``SPLIT_BUILDS`` (``DIA_SPLIT_PDL``:
1 makes a chained launch a programmatic dependent launch) on each matrix
of ``SPLIT_SHAPES`` (random legs on the full box of a 3-D stencil's shifts
folded into DIA offsets, and a band of 300 diagonals) in fp32 and fp64,
launched by
``cuda_dia.dia_plan(split=S)`` for every S of ``SPLITS`` (S = 1: the
unsplit chain) beside the plan's own S, each replayed from a CUDA graph:
#4's SpMV and fused p·Ap and #5's chained SpMM at k = 4, beside
cuSPARSE's CSR product of the same matrix replayed the same way.

Every variant is held to the twin first (max error <= 1e-5 of max |twin|,
1e-13 in fp64).  The launches go through the wrappers' launch helpers, not
the wrappers, so the kernels' launch counts do not move.  The last line is
one JSON record: ``{"card": ..., "spmm_dia": {variant: {shape: ms}},
"spmv_dia": {shape: ms}, "spmm_dia_acc": {variant: {shape: ms}}, "split":
{shape: {S: {op: ms}}}}``.  Needs a CUDA device.
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
from conjugategradient_tpu_torch.ops.card import (
    SMS,
    blocks_per_sm,
    bound_ms,
    card_name,
    dia_csr,
    dia_nnz,
    graph_ms,
    time_ms,
)
from conjugategradient_tpu_torch.scripts.dia_times import box_dia

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
#: kernel #6's builds, the shipped design first (the default build, shared
#: with #5's shipped one)
ACC_BUILDS = {
    "ACC_TILE=256 ACC_LEGS=8 ACC_STAGES=3": (),
    "ACC_STAGES=2": ("ACC_STAGES=2",),
    "ACC_STAGES=4": ("ACC_STAGES=4",),
    "ACC_TILE=128": ("ACC_TILE=128",),
    "ACC_TILE=512": ("ACC_TILE=512",),
    "ACC_LEGS=4": ("ACC_LEGS=4",),
    "ACC_LEGS=16": ("ACC_LEGS=16",),
}
FLAGSHIP_N = 207_402
#: kernel #6's main shape: its experiment's n, band and k
ACC_N, ACC_BAND, ACC_K = 414_720, 160, 8


#: the split sweep: (label, rows of a cube's side or of a band, stencil
#: halo or band width); the splits timed at each
SPLIT_SHAPES = (("16^3 x 343", 16, 3), ("16^3 x 1331", 16, 5), ("32^3 x 343", 32, 3),
                ("band 300 n=4000", 4000, 300))
SPLITS = (1, 2, 4, 8, 16, 32)
SPLIT_K = 4
#: the split form's builds, the shipped design first
SPLIT_BUILDS = {"DIA_SPLIT_PDL=1 DIA_SPLIT_BYTES=128": (), "DIA_SPLIT_PDL=0": ("DIA_SPLIT_PDL=0",)}


def _many_diagonals(label, side, width, dev):
    """A device fp64 DIA matrix past 256 diagonals with random legs (a
    leg's entries whose neighbour leaves [0, n) zero): the (2h + 1)^3 box of
    a stencil on side^3 folded into offsets (``dia_times.box_dia``), or a
    band of ``width`` diagonals on ``side`` rows."""
    if not label.startswith("band"):
        return box_dia(side, width).device_put(torch.float64, dev)
    offs = tuple(range(-(width // 2), width - width // 2))
    i = torch.arange(side, device=dev)
    data = torch.randn((len(offs), side), device=dev, dtype=torch.float64,
                       generator=torch.Generator(device=dev).manual_seed(width))
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= side)] = 0.0
    return DiaMatrix(data, offs, (side, side))


def _split_sweep(dev, card, record):
    """Kernels #4 (SpMV, fused p·Ap) and #5 (chained, k = SPLIT_K) at every
    S of SPLITS on each SPLIT_SHAPES matrix, fp32 and fp64, held to the
    twins, then replayed from CUDA graphs beside cuSPARSE."""
    record["split"] = {}
    for build, defines in SPLIT_BUILDS.items():
        _split_build(build, _build.load("dia", defines), dev, card, record["split"])


def _split_build(build, lib, dev, card, record):
    """``_split_sweep``'s shapes and splits on one build of ``csrc/dia.cu``."""
    for label, side, width in SPLIT_SHAPES:
        A64 = _many_diagonals(label, side, width, dev)
        for legs in (torch.float32, torch.float64):
            A = DiaMatrix(A64.data.to(legs), A64.offsets, A64.shape)
            g = torch.Generator(device=dev).manual_seed(7)
            x = torch.randn(A.n, generator=g, device=dev, dtype=legs)
            X = torch.randn((SPLIT_K, A.n), generator=g, device=dev, dtype=legs)
            code = cd._CODES[(legs, legs)]
            ref, refY = cd.spmv_dia_ref(A, x), cd.spmm_dia_ref(A, X)
            rel = REL64 if legs == torch.float64 else REL
            nnz, size = dia_nnz(A), A.data.element_size()
            b1 = bound_ms(nnz * size + 2 * A.n * size, 2 * nnz)[0]
            bk = bound_ms(nnz * size + 2 * SPLIT_K * A.n * size, 2 * SPLIT_K * nnz)[0]
            csr = dia_csr(A)
            Xt = X.T.contiguous()
            lib_ms = (graph_ms(lambda: csr @ x, 200), graph_ms(lambda: csr @ Xt, 100))
            tag = f"{label} {cd.TAGS[legs]}"
            own = cd.dia_split(A.n, A.ndiags)
            row = record.setdefault(build, {}).setdefault(tag, {"plan": own, "csr": lib_ms})
            for s in SPLITS:
                plan = cd.dia_plan(A.n, A.ndiags, split=s)
                y, _ = cd._spmv_launch(lib, code, A, x, plan)
                yd, dot = cd._spmv_launch(lib, code, A, x, plan, dot=True)
                Y = cd._spmm_launch(lib, code, A, X, plan)
                for what, out, want in (("spmv", y, ref), ("spmm", Y, refY)):
                    err = float((out - want).abs().max())
                    if not err <= rel * float(want.abs().max()):
                        raise RuntimeError(f"split {tag} S={s} {what}: max err {err:.3e}")
                if not (torch.equal(yd, y) and all(torch.equal(Y[j], cd._spmv_launch(
                        lib, code, A, X[j].contiguous(), plan)[0]) for j in range(SPLIT_K))):
                    raise RuntimeError(f"split {tag} S={s}: a column or the fused y differs")
                ms = {"spmv": graph_ms(lambda: cd._spmv_launch(lib, code, A, x, plan), 200),
                      "spmv_dot": graph_ms(lambda: cd._spmv_launch(lib, code, A, x, plan, dot=True),
                                           200),
                      f"spmm k={SPLIT_K}": graph_ms(lambda: cd._spmm_launch(lib, code, A, X, plan),
                                                    100)}
                row[s] = ms
                print(f"time split [{build}] {tag} S={s}{' (the plan)' if s == own else ''}: "
                      + ", ".join(f"{op} {v:.4f} ms" for op, v in ms.items())
                      + f"; bound {b1:.4f} / {bk:.4f} ms; CSR {lib_ms[0]:.4f} / {lib_ms[1]:.4f} ms "
                      f"[{card}]")


def _threads(defines) -> int:
    return next((int(d.split("=")[1]) for d in defines if d.startswith("SPMM_THREADS=")), 256)


def _seven_diagonals(g, dev):
    """The 255^3 operator's offsets as a 7-diagonal DIA with random legs."""
    n, p = 255**3, 255**2
    offsets = (-p, -255, -1, 0, 1, 255, p)
    return DiaMatrix(torch.rand((7, n), generator=g, device=dev), offsets, (n, n))


def _cases(dev):
    """(label, device DiaMatrix, X) of kernel #5's timed shapes."""
    band = generators.banded_sin_matrix(FLAGSHIP_N, 160)
    g = torch.Generator(device=dev).manual_seed(0)
    for legs, k in ((torch.float32, 4), (torch.bfloat16, 4), (torch.float64, 4), (torch.float32, 8),
                    (torch.float32, 1)):
        A = band.device_put(legs, dev)
        vec = torch.float64 if legs == torch.float64 else torch.float32
        yield f"band 160 k={k} {cd.TAGS[legs]}", A, torch.randn((k, A.n), generator=g, device=dev).to(vec)
    yield "255^3 7 diagonals k=4 fp32", _seven_diagonals(g, dev), torch.randn((4, 255**3), generator=g,
                                                                               device=dev)


def _acc_cases(dev):
    """(label, device DiaMatrix, X) of kernel #6's timed shapes."""
    g = torch.Generator(device=dev).manual_seed(1)
    main = generators.banded_sin_matrix(ACC_N, ACC_BAND)
    for legs in (torch.float32, torch.bfloat16):
        yield (f"n={ACC_N} band {ACC_BAND} k={ACC_K} {cd.TAGS[legs]}", main.device_put(legs, dev),
               torch.randn((ACC_K, ACC_N), generator=g, device=dev))
    A = generators.banded_sin_matrix(FLAGSHIP_N, 160).device_put(torch.float32, dev)
    yield "band 160 k=4 fp32 (flagship)", A, torch.randn((4, FLAGSHIP_N), generator=g, device=dev)
    yield "255^3 7 diagonals k=4 fp32", _seven_diagonals(g, dev), torch.randn((4, 255**3), generator=g,
                                                                               device=dev)


def _time_variants(label_fn, builds, launch, ref, nbytes, bound, shape, card, record):
    """Hold each build's kernel to the twin, then time it; ``launch(lib)``
    runs it on the shape's inputs."""
    rel = REL64 if ref.dtype == torch.float64 else REL
    scale = float(ref.abs().max())
    for label, defines in builds.items():
        lib = _build.load("dia", defines)
        err = float((launch(lib) - ref).abs().max())
        if not err <= rel * scale:
            raise RuntimeError(f"{label_fn} [{label}] {shape}: max err {err:.3e} > {rel}*{scale:.3e}")
        ms = time_ms(lambda: launch(lib), 100)
        record[label][shape] = ms
        print(f"time {label_fn} [{label}] {shape}: {ms:.4f} ms (bound {bound:.4f} ms of "
              f"{nbytes / 1e6:.1f} MB, {bound / ms:.1%} of it) [{card}]")


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("dia_tuning: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_name()
    print(card)
    if "--split" in (sys.argv[1:] if argv is None else argv):
        with cf.ThreadPoolExecutor(len(SPLIT_BUILDS)) as pool:
            list(pool.map(lambda d: _build.build(["dia"], d), SPLIT_BUILDS.values()))
        record = {"card": card}
        _split_sweep(dev, card, record)
        print(json.dumps(record))
        return 0
    every = list(BUILDS.values()) + list(ACC_BUILDS.values())[1:] + list(SPLIT_BUILDS.values())[1:]
    with cf.ThreadPoolExecutor(len(every)) as pool:
        list(pool.map(lambda d: _build.build(["dia"], d), every))
    for label, defines in BUILDS.items():
        for entry, res in sorted(_build.kernel_resources("dia", defines).items()):
            if "spmm_dia_kernel" in entry:
                t = _threads(defines)
                per_sm = blocks_per_sm(res["registers"], t)
                waves = -(-FLAGSHIP_N // t) / (SMS * per_sm)
                print(f"ptxas dia [{label}] {entry[:60]}: {res}; {per_sm} blocks/SM, "
                      f"{waves:.2f} waves at n = {FLAGSHIP_N}")
    main_offsets = tuple(range(-(ACC_BAND // 2) + 1, ACC_BAND // 2))
    for label, defines in ACC_BUILDS.items():
        lib = _build.load("dia", defines)
        geo = cd.acc_geometry(main_offsets, ACC_N, ACC_K, lib.cg_spmm_dia_acc_tile(),
                              lib.cg_spmm_dia_acc_stages())
        tile = lib.cg_spmm_dia_acc_tile()
        for entry, res in sorted(_build.kernel_resources("dia", defines).items()):
            if "spmm_dia_acc_kernel" not in entry:
                continue
            shape = ""
            if f"Li{ACC_K}E" in entry:  # the main shape's instantiations
                per_sm = blocks_per_sm(res["registers"], tile, geo.smem_bytes)
                shape = (f"; at n = {ACC_N} band {ACC_BAND} k = {ACC_K}: {geo.smem_bytes} B shared, "
                         f"{per_sm} blocks/SM, {geo.blocks / (SMS * per_sm):.2f} waves of "
                         f"{geo.blocks} blocks ({geo.interior} interior)")
            print(f"ptxas dia [{label}] {entry[:60]}: {res}{shape}")
    record = {"card": card, "spmm_dia": {label: {} for label in BUILDS},
              "spmm_dia_acc": {label: {} for label in ACC_BUILDS}}
    for shape, A, X in _cases(dev):
        code = cd._CODES[(A.data.dtype, X.dtype)]
        ref = cd.spmm_dia_ref(A, X)
        nbytes = dia_nnz(A) * A.data.element_size() + 2 * X.numel() * X.element_size()
        bound = bound_ms(nbytes, 2 * X.shape[0] * dia_nnz(A))[0]
        _time_variants("spmm_dia", BUILDS, lambda lib: cd._spmm_launch(lib, code, A, X), ref, nbytes,
                       bound, shape, card, record["spmm_dia"])
        if X.shape[0] == 1:
            ms = time_ms(lambda: cd.spmv_dia_cuda(A, X[0]), 100)
            record["spmv_dia"] = {shape: ms}
            print(f"time spmv_dia (kernel #4) {shape}: {ms:.4f} ms [{card}]")
        del ref
    shipped = _build.load("dia")
    for shape, A, X in _acc_cases(dev):
        code = cd._CODES[(A.data.dtype, X.dtype)]
        ref = cd.spmm_dia_acc_ref(A, X)
        nbytes = dia_nnz(A) * A.data.element_size() + 2 * X.numel() * X.element_size()
        bound = bound_ms(nbytes, 2 * X.shape[0] * dia_nnz(A))[0]
        _time_variants("spmm_dia_acc", ACC_BUILDS, lambda lib: cd._acc_launch(lib, code, A, X), ref,
                       nbytes, bound, shape, card, record["spmm_dia_acc"])
        ms5 = time_ms(lambda: cd._spmm_launch(shipped, code, A, X), 100)
        record["spmm_dia_acc"].setdefault("kernel #5 (shipped)", {})[shape] = ms5
        print(f"time spmm_dia (kernel #5, shipped) {shape}: {ms5:.4f} ms ({bound / ms5:.1%} of the "
              f"bound) [{card}]")
        del ref, A, X
    _split_sweep(dev, card, record)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
