"""Design constants of kernels #1, #2 and #3, measured on the card.

    python -m conjugategradient_tpu_torch.scripts.stencil_tuning [--only var cheb const wide]

Builds ``csrc/stencil_var.cu`` (kernel #3) and ``csrc/stencil.cu`` (kernels
#1 and #2) once for each value of a compile-time design constant (``nvcc
-D``; all builds started together), prints each build's ``ptxas`` lines for
the three kernels, and times each build at the main path's shapes with CUDA
events after a warm-up:

- kernel #1, ``CONST_ZRUN`` (z planes a thread marches), random
  coefficients: the 7-point star at 255^3, the 27-point box at 127^3, the
  5-point star and 9-point box at 1023^2, the 1-D 3-point at 2^20 - 1, each
  in fp32 and fp64, and the 7-point star's legs reversed at 255^3 fp32 (the
  run-time instantiation), replayed from a CUDA graph (``graph_ms``: below
  2 M points the host's launch rate would set the time);

- kernel #3, ``ZRUN`` (z planes a thread marches) and ``BATCH_BYTES`` (loads
  issued before the first FMA): 255^3 with 7 legs (fp32, bf16, fp64) and
  127^3 with 27 legs (fp32, bf16), random legs;
- the wide kernel #3, ``WIDE_GROUP_BYTES`` (leg and x bytes loaded before
  the first FMA), each build at every power-of-two split of the legs the
  launch holds (``wide_geometry(split=)``; split blocks also with half
  their rows; the default launch marked): the
  shapes of ``scripts/wide_times.py`` (the 256^3 Galerkin hierarchy's 128^3
  x 81, 64^3 x 125, 32^3 x 343 and 16^3 x 1331, 512^2 x 21, 1-D 32768 x 5),
  fp32 legs, and 128^3 x 81 with bf16 and fp64 legs at the default split,
  below 2e7 leg entries replayed from a CUDA graph;
- kernel #2, ``CHEB_TY`` (interior tile rows) and ``CHEB_MINB`` (blocks per
  SM asked of ptxas), each at z chunks of 16, 32, 64 and 128 planes:
  Poisson, degree 2, at 255^3 and 127^3 the pre-smooth (zero x0, residual)
  and the post-smooth (given x0), at 255^3 also the given-x0-with-residual
  variant (h = 3) and the
  pre-smooth with the legs in reverse order (the instantiation that reads
  its shifts at run time, against the compile-time 7-point pattern).

Every variant is held to the twin first (max error <= 1e-5 of max |twin|,
1e-13 in fp64).  The launches go through the wrappers' launch helpers, not
the wrappers, so no launch count moves.  The last line is one JSON record:
``{"card": ..., "spmv_stencil": {variant: {shape: ms}}, "cheb_smooth_const":
{variant: {shape: ms}}, "spmv_const_stencil": {variant: {shape: ms}},
"spmv_stencil_wide": {variant: {shape: ms}}}`` (``--only``: the named
kernels alone).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import concurrent.futures as cf
import itertools
import json
import sys

import torch

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, StencilMatrix
from conjugategradient_tpu_torch.ops import _build
from conjugategradient_tpu_torch.ops import cuda_stencil as cs
from conjugategradient_tpu_torch.ops.card import card_name, graph_ms, time_ms
from conjugategradient_tpu_torch.scripts.wide_times import SHAPES as WIDE_SHAPES

REL, REL64 = 1e-5, 1e-13
#: build label -> -D overrides; the first of each is the shipped design
VAR_BUILDS = {
    "ZRUN=4 BATCH_BYTES=16": (),
    "ZRUN=4 BATCH_BYTES=32": ("BATCH_BYTES=32",),
    "ZRUN=4 BATCH_BYTES=64": ("BATCH_BYTES=64",),
    "ZRUN=8 BATCH_BYTES=16": ("ZRUN=8",),
    "ZRUN=8 BATCH_BYTES=32": ("ZRUN=8", "BATCH_BYTES=32"),
    "ZRUN=16 BATCH_BYTES=32": ("ZRUN=16", "BATCH_BYTES=32"),
}
CONST_BUILDS = {
    "CONST_ZRUN=4": (),
    "CONST_ZRUN=2": ("CONST_ZRUN=2",),
    "CONST_ZRUN=8": ("CONST_ZRUN=8",),
}
WIDE_BUILDS = {
    "WIDE_GROUP_BYTES=128": (),
    "WIDE_GROUP_BYTES=64": ("WIDE_GROUP_BYTES=64",),
    "WIDE_GROUP_BYTES=96": ("WIDE_GROUP_BYTES=96",),
}
CHEB_BUILDS = {
    "CHEB_TY=16 CHEB_MINB=2": (),
    "CHEB_MINB=1": ("CHEB_MINB=1",),
    "CHEB_TY=8": ("CHEB_TY=8",),
    "CHEB_TY=8 CHEB_MINB=4": ("CHEB_TY=8", "CHEB_MINB=4"),
}
#: the 7-point and 27-point shifts in the order dia_to_stencil gives them
SHIFTS7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))
SHIFTS27 = tuple(itertools.product((-1, 0, 1), repeat=3))
#: the 3-D Poisson stencil (poisson_system's): 6 on the centre, -1 around
POISSON = tuple(6.0 if s == (0, 0, 0) else -1.0 for s in SHIFTS7)


def _err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    return (max(float((o - r).abs().max()) for o, r in zip(outs, refs)),
            max(float(r.abs().max()) for r in refs))


def _var_cases(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    for label, grid, shifts in (("255^3 7 legs", (255,) * 3, SHIFTS7),
                                ("127^3 27 legs", (127,) * 3, SHIFTS27)):
        legs32 = torch.rand((len(shifts),) + grid, generator=g, device=dev)
        dtypes = (torch.float32, torch.bfloat16) + ((torch.float64,) if len(shifts) == 7 else ())
        for legs in dtypes:
            vec = torch.float64 if legs == torch.float64 else torch.float32
            A = StencilMatrix(legs32.to(legs), shifts, grid)
            x = torch.randn(grid, generator=g, device=dev).to(vec)
            yield f"{label} {cs.TAGS[legs]}", A, x


def _const_cases(dev):
    """(label, operator, x) of kernel #1's timed shapes."""
    g = torch.Generator(device=dev).manual_seed(2)
    box2 = tuple(s[1:] for s in SHIFTS27 if s[0] == 0)
    star2 = ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0))
    for label, shifts, grid in (("255^3 7-point", SHIFTS7, (255,) * 3),
                                ("127^3 27-point", SHIFTS27, (127,) * 3),
                                ("1023^2 5-point", star2, (1023, 1023)),
                                ("1023^2 9-point", box2, (1023, 1023)),
                                ("(1048575,) 3-point", ((-1,), (0,), (1,)), (2**20 - 1,)),
                                ("255^3 7-point reversed", SHIFTS7[::-1], (255,) * 3)):
        coeffs = tuple(float(c) for c in torch.rand(len(shifts), generator=g, device=dev) - 0.5)
        A = ConstStencilMatrix(coeffs, shifts, grid)
        for dtype in (torch.float32,) if "reversed" in label else (torch.float32, torch.float64):
            yield f"{label} {cs.TAGS[dtype]}", A, torch.randn(grid, generator=g, device=dev).to(dtype)


def _cheb_cases(dev):
    g = torch.Generator(device=dev).manual_seed(1)
    invd = torch.tensor(1.0 / 6.0, device=dev)
    for n in (255, 127):
        grid = (n,) * 3
        A = ConstStencilMatrix(POISSON, SHIFTS7, grid)
        b, x0 = (torch.randn(grid, generator=g, device=dev) for _ in range(2))
        cases = [("pre: zero x0 + resid", A, None, True), ("post: given x0", A, x0, False)]
        if n == 255:
            # the same operator with its legs in reverse order: no
            # compile-time pattern, the shifts read at run time
            Ar = ConstStencilMatrix(POISSON[::-1], SHIFTS7[::-1], grid)
            cases += [("h=3: given x0 + resid", A, x0, True), ("pre, shifts at run time", Ar, None, True)]
        for label, op, xin, resid in cases:
            yield f"{n}^3 degree 2 {label}", (op, b, xin, 2, 2.0, 0.5, invd, resid)


def _wide_cases(dev):
    """(shape, operator, x, splits to time) of the wide kernel's timed
    shapes: every power-of-two split the launch holds in fp32, the default
    one with bf16 and fp64 legs."""
    for label, grid, shifts, dtypes in WIDE_SHAPES:
        g = torch.Generator(device=dev).manual_seed(len(shifts))
        legs32 = torch.rand((len(shifts),) + grid, generator=g, device=dev) * 2 - 1
        view = cs.wide_view(grid, shifts)
        most = min(len(shifts), cs.WIDE_MAX_THREADS // cs.wide_geometry(view, 1).block[0])
        for legs in dtypes:
            vec = torch.float64 if legs == torch.float64 else torch.float32
            A = StencilMatrix(legs32.to(legs), shifts, grid)
            x = torch.randn(grid, generator=g, device=dev).to(vec)
            splits = ([1 << i for i in range(most.bit_length()) if 1 << i <= most]
                      if legs == torch.float32 else [None])
            yield f"{label} {cs.TAGS[legs]}", A, x, view, splits


def _wide_times(record, card, dev):
    for label, defines in WIDE_BUILDS.items():
        lib = _build.load("stencil_var", defines)
        row = record["spmv_stencil_wide"][label] = {}
        for shape, A, x, view, splits in _wide_cases(dev):
            code = cs._CODES[(A.data.dtype, x.dtype)]
            table = cs._wide_table(view, x.device)
            ref = cs.spmv_stencil_ref(A, x)
            default = cs.wide_geometry(view, A.nlegs)
            big = x.numel() * A.nlegs > 2e7
            geos = []
            for split in splits:
                geo = cs.wide_geometry(view, A.nlegs, split=split)
                geos.append(geo)
                bx, rows = geo.block
                if geo.split > 1 and rows > 1:  # the same split in blocks of half the rows
                    geos.append(geo._replace(block=(bx, rows // 2), grid=(
                        geo.grid[0], -(-view.dims[1] // (rows // 2)), geo.grid[2])))
            for geo in geos:
                fn = lambda: cs._wide_launch(lib, code, A, x, view, table, geo)
                err, scale = _err(fn(), ref)
                rel = REL64 if x.dtype == torch.float64 else REL
                if not err <= rel * scale:
                    raise RuntimeError(f"wide [{label}] {shape} {geo}: max err {err:.3e} > "
                                       f"{rel}*{scale:.3e}")
                ms = (time_ms if big else graph_ms)(fn, 50 if big else 200)
                key = (f"{shape} split {geo.split} block {geo.block}"
                       f"{' (default)' if geo == default else ''}")
                row[key] = ms
                print(f"time spmv_stencil_wide [{label}] {key}, zrun {geo.zrun}: {ms:.4f} ms"
                      f"{'' if big else ' (graph)'} [{card}]")
            del A, x, table, ref


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="+", choices=("var", "cheb", "const", "wide"),
                    default=("var", "cheb", "const", "wide"))
    only = set(ap.parse_args(argv).only)
    if not torch.cuda.is_available():
        print("stencil_tuning: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = card_name()
    print(card)
    groups = {"var": ("stencil_var", VAR_BUILDS, "spmv_var_kernel"),
              "wide": ("stencil_var", WIDE_BUILDS, "spmv_var_wide_kernel"),
              "cheb": ("stencil", CHEB_BUILDS, "cheb_const_kernel"),
              "const": ("stencil", CONST_BUILDS, "spmv_const_kernel")}
    builds = {(src, label): (d, kernel) for key, (src, table, kernel) in groups.items()
              if key in only for label, d in table.items()}
    # one nvcc per build, all started together
    unique = sorted({(src, d) for (src, _), (d, _) in builds.items()})  # one nvcc per library
    with cf.ThreadPoolExecutor(len(unique)) as pool:
        list(pool.map(lambda sd: _build.build([sd[0]], sd[1]), unique))
    for (src, label), (defines, kernel) in builds.items():
        for entry, res in sorted(_build.kernel_resources(src, defines).items()):
            if kernel in entry:
                print(f"ptxas {src} [{label}] {entry[:60]}: {res}")
    record = {"card": card, "spmv_stencil": {}, "cheb_smooth_const": {}, "spmv_const_stencil": {},
              "spmv_stencil_wide": {}}
    if "wide" in only:
        _wide_times(record, card, dev)

    for label, defines in CONST_BUILDS.items() if "const" in only else ():
        lib = _build.load("stencil", defines)
        row = record["spmv_const_stencil"][label] = {}
        for shape, A, x in _const_cases(dev):
            fn = lambda: cs._const_launch(lib, A, x)
            err, scale = _err(fn(), cs.spmv_const_stencil_ref(A, x))
            rel = REL64 if x.dtype == torch.float64 else REL
            if not err <= rel * scale:
                raise RuntimeError(f"spmv_const [{label}] {shape}: max err {err:.3e} > {rel}*{scale:.3e}")
            ms = graph_ms(fn, 200 if x.numel() < 2e6 else 50)
            gb = 2 * x.numel() * x.element_size() / 1e9
            row[shape] = ms
            print(f"time spmv_const_stencil [{label}] {shape}: {ms:.4f} ms "
                  f"({gb / (ms * 1e-3):.0f} GB/s of {gb * 1e3:.1f} MB) [{card}]")

    for label, defines in VAR_BUILDS.items() if "var" in only else ():
        lib = _build.load("stencil_var", defines)
        row = record["spmv_stencil"][label] = {}
        for shape, A, x in _var_cases(dev):
            code = cs._CODES[(A.data.dtype, x.dtype)]
            fn = lambda: cs._var_launch(lib, code, A, x)
            err, scale = _err(fn(), cs.spmv_stencil_ref(A, x))
            rel = REL64 if x.dtype == torch.float64 else REL
            if not err <= rel * scale:
                raise RuntimeError(f"spmv_stencil [{label}] {shape}: max err {err:.3e} > {rel}*{scale:.3e}")
            ms = time_ms(fn, 50)
            gb = (A.data.numel() * A.data.element_size() + 2 * x.numel() * x.element_size()) / 1e9
            row[shape] = ms
            print(f"time spmv_stencil [{label}] {shape}: {ms:.4f} ms ({gb / (ms * 1e-3):.0f} GB/s) "
                  f"[{card}]")
            del A, x

    for label, defines in CHEB_BUILDS.items() if "cheb" in only else ():
        lib = _build.load("stencil", defines)
        row = record["cheb_smooth_const"][label] = {}
        for shape, args in _cheb_cases(dev):
            A, b, xin, degree, hi, lo, invd, resid = args
            ref = cs.cheb_smooth_const_ref(*args)
            geo = cs.cheb_geometry(degree, xin is None, resid)
            ty = dict(d.split("=") for d in defines).get("CHEB_TY")
            if ty is not None and geo.h <= 4:
                geo = geo._replace(tile=(geo.tile[0], int(ty)))
            for chunk in cs.CHEB_CHUNKS:
                g = geo._replace(chunk=chunk)
                fn = lambda: cs._cheb_launch(lib, A, b, xin, degree, hi, lo, invd, resid, g)
                out = fn()
                err, scale = _err(out if resid else out[0], ref)
                if not err <= REL * scale:
                    raise RuntimeError(f"cheb [{label}] {shape} chunk {chunk}: max err {err:.3e}")
                ms = time_ms(fn, 20)
                row[f"{shape}, chunk {chunk}"] = ms
                print(f"time cheb_smooth_const [{label}] {shape}, tile {g.tile}, chunk {chunk}: "
                      f"{ms:.4f} ms [{card}]")
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
