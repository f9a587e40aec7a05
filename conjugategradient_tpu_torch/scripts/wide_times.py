"""The wide kernel #3 timed at the multigrid paths' shapes, to compare
checkouts on one card.

    PYTHONPATH=<checkout> python <this file>

Imports ``conjugategradient_tpu_torch`` from wherever ``PYTHONPATH`` points,
so one copy of this file times any checkout of the port that has the wide
kernel: it calls only ``StencilMatrix`` and ``ops.cuda_stencil.
spmv_stencil_wide_cuda(A, x)``.  Random legs (seeded) on the shifts of the
paths' wide levels: the 256^3 Galerkin Poisson hierarchy's 128^3 x 81 (fp32,
bf16 and fp64 legs), 64^3 x 125, 32^3 x 343 and 16^3 x 1331, the 1024^2
hierarchy's 512^2 x 21 and the 65,536-row tridiagonal's 32768 x 5.  Each is
held to the twin (the wrapper on CPU copies: 1e-5 of max |y|, 1e-13 in fp64),
then timed with CUDA events after a warm-up, replayed from a CUDA graph below
2e7 leg entries (``graph_ms``), beside its bound (each in-grid leg entry, x
and y once at 3.35 TB/s) and cuSPARSE's CSR product of the same operator
(legs upcast to fp32 for bf16), with the split of the legs the launch takes
where the checkout has one (``wide_geometry``).  Prints one JSON record per
shape.  Needs a CUDA device.  ``stencil_tuning.py`` times every split and
group size of the current checkout.
"""

from __future__ import annotations

import argparse
import itertools
import json
import subprocess
import sys

import torch

from conjugategradient_tpu_torch.core.formats import StencilMatrix
from conjugategradient_tpu_torch.ops import cuda_stencil as cs


def _box(h, d):
    return tuple(itertools.product(range(-h, h + 1), repeat=d))


#: (label, grid, shifts, leg dtypes)
SHAPES = (
    ("128^3 81 legs", (128,) * 3, tuple(s for s in _box(2, 3) if sum(abs(c) == 2 for c in s) <= 1),
     (torch.float32, torch.bfloat16, torch.float64)),
    ("64^3 125 legs", (64,) * 3, _box(2, 3), (torch.float32,)),
    ("32^3 343 legs", (32,) * 3, _box(3, 3), (torch.float32,)),
    ("16^3 1331 legs", (16,) * 3, _box(5, 3), (torch.float32,)),
    ("512^2 21 legs", (512, 512), tuple(s for s in _box(2, 2) if abs(s[0]) + abs(s[1]) < 4),
     (torch.float32,)),
    ("1-D 32768 5 legs", (32768,), _box(2, 1), (torch.float32,)),
)
HBM = 3.35e12


def _time(fn, reps, graph):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(reps):
                fn()
        g.replay()
        torch.cuda.synchronize()
        start.record()
        g.replay()
    else:
        start.record()
        for _ in range(reps):
            fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _csr(A):
    """The stencil as a CSR tensor: its legs as diagonals at the folded flat
    offsets, each row's in-grid entries (legs in fp32, or fp64)."""
    grid, n = A.grid, A.n
    strides = [1] * len(grid)
    for ax in range(len(grid) - 2, -1, -1):
        strides[ax] = strides[ax + 1] * grid[ax + 1]
    dev = A.data.device
    idx = torch.stack(torch.meshgrid(*[torch.arange(g, device=dev) for g in grid], indexing="ij"))
    idx = idx.reshape(len(grid), -1)
    rows, cols, vals = [], [], []
    val_dtype = torch.float64 if A.data.dtype == torch.float64 else torch.float32
    for k, sh in enumerate(A.shifts):
        nb = idx + torch.tensor(sh, device=dev)[:, None]
        keep = ((nb >= 0) & (nb < torch.tensor(grid, device=dev)[:, None])).all(0)
        p = torch.nonzero(keep).squeeze(1)
        rows.append(p)
        cols.append(p + sum(s * st for s, st in zip(sh, strides)))
        vals.append(A.data[k].reshape(-1)[p].to(val_dtype))
    r, c, v = torch.cat(rows), torch.cat(cols), torch.cat(vals)
    coo = torch.sparse_coo_tensor(torch.stack([r, c]), v, (n, n)).coalesce()
    return coo.to_sparse_csr()


def measure(label, grid, shifts, legs) -> dict:
    g = torch.Generator(device="cuda").manual_seed(len(shifts))
    data = (torch.rand((len(shifts),) + grid, generator=g, device="cuda") * 2 - 1).to(legs)
    A = StencilMatrix(data, shifts, grid)
    vec = torch.float64 if legs == torch.float64 else torch.float32
    x = torch.randn(grid, generator=g, device="cuda").to(vec)
    fp64 = legs == torch.float64
    rel = 1e-13 if fp64 else 1e-5
    ref = cs.spmv_stencil_ref(A, x)
    n = x.numel()
    big = n * len(shifts) > 2e7
    reps = 50 if big else 200
    nbytes = A.nnz * data.element_size() + 2 * n * x.element_size()
    rec = {"shape": label, "legs": str(legs).replace("torch.", ""), "bound_ms": nbytes / HBM * 1e3,
           "graph": not big}
    if hasattr(cs, "wide_geometry"):
        rec["split"] = cs.wide_geometry(cs.wide_view(grid, shifts), len(shifts)).split
    y = cs.spmv_stencil_wide_cuda(A, x)
    err, scale = float((y - ref).abs().max()), float(ref.abs().max())
    if not err <= rel * scale:
        raise RuntimeError(f"{label}: max err {err:.3e} > {rel} * {scale:.3e}")
    rec["kernel ms"] = _time(lambda: cs.spmv_stencil_wide_cuda(A, x), reps, not big)
    csr = _csr(A)
    xf = x.reshape(-1).to(csr.dtype)
    out = csr @ xf
    if not float((out.to(y.dtype) - y.reshape(-1)).abs().max()) <= 1e-5 * float(ref.abs().max()):
        raise RuntimeError(f"{label}: the CSR product differs from the kernel")
    rec["csr ms"] = _time(lambda: csr @ xf, reps, False)
    return rec


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("wide_times: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    for label, grid, shifts, dtypes in SHAPES:
        for legs in dtypes:
            print(json.dumps({"card": card, **measure(label, grid, shifts, legs)}))
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
