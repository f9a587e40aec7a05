"""The probed hierarchy setup on the card against the host build, on one
grid.

    python -m conjugategradient_tpu_torch.scripts.probed_setup_bench \\
        [--grid 127 127 127] [--shards 1] [--dtype float32] [--probed-only] [--cpu]

Assembles the rung-5 Poisson system (``parallel.rung5.make_rung5_system``:
axis 0 identity-padded to a multiple of the shards, slab by slab) in
``--dtype`` on ``--shards`` shards of the card and builds its hierarchy on
the shards (``precond.distributed.build_hierarchy_probed``); then, from the
same padded operator in fp64 on the host, the port's host build
(``precond.multigrid.build_hierarchy(..., sa_smooth_levels=0,
layout="stencil")``, placed on the card), each timed by the host clock to a
synchronise, and MGCG (``rel_l2`` 1e-6) on each hierarchy over the same
shards (``probed_vs_host``, which ``chip_smoke.py`` runs too).  Prints one
JSON record: the grid, the assembly and both setup times (by phase), each
hierarchy's levels, the probed build's two near-null Rayleigh quotients a
level, both iteration counts, the probed solve's true fp64 relative
residual on the real rows (host oracle), and the card's name and power
limit.  ``--probed-only`` stops after the probed build (the host build of a
grid past a few million rows takes minutes to hours).  Needs a CUDA device;
``--cpu`` runs the same on CPU shards (the kernels' twins: host numbers,
not the card's).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.core.formats import StencilMatrix, stencil_to_dia
from conjugategradient_tpu_torch.ops.card import card_name
from conjugategradient_tpu_torch.parallel import make_mesh, make_shard_mgcg, rung5
from conjugategradient_tpu_torch.precond.distributed import build_hierarchy_probed
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _timed(fn, dev):
    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def probed(grid, mesh, dtype=np.float32) -> dict:
    """The rung-5 Poisson system on ``grid`` assembled onto ``mesh`` in
    ``dtype`` and its probed hierarchy: ``A``, ``b``, ``x0``, ``padded``,
    ``h`` and the host-clock seconds ``assembly_s``, ``setup_s``."""
    dev = mesh.local_devices[0]
    (A, b, x0, padded, _), t_asm = _timed(
        lambda: rung5.make_rung5_system(grid, mesh, dtype=dtype), dev)
    h, t_setup = _timed(lambda: build_hierarchy_probed(A, mesh), dev)
    return dict(A=A, b=b, x0=x0, padded=padded, h=h, assembly_s=t_asm, setup_s=t_setup)


def probed_vs_host(grid, mesh, policy, dtype=np.float32) -> dict:
    """``probed``'s, then the port's host build of the same padded operator
    (fp64 Galerkin products on the host, cast to ``dtype``, placed on the
    mesh's first device: ``host_h``, ``host_setup_s``) and MGCG under
    ``policy`` over the same shards on each hierarchy (``res``,
    ``host_res``; ``solve_s`` the probed solve's first call)."""
    dev = mesh.local_devices[0]
    out = probed(grid, mesh, dtype)
    A, padded = out["A"], out["padded"]
    legs64 = rung5.poisson_stencil_slab(grid, 0, padded[0], np.float64)
    A_dia = stencil_to_dia(StencilMatrix(legs64, A.shifts, padded))
    del legs64
    out["host_h"], out["host_setup_s"] = _timed(
        lambda: build_hierarchy(A_dia, padded, sa_smooth_levels=0, layout="stencil",
                                dtype=dtype, const_detect=False, device=dev), dev)
    out["res"], out["solve_s"] = _timed(
        lambda: rung5.make_rung5_mgcg(policy, out["h"])(out["b"], out["x0"]), dev)
    sys_h = generators.LinearSystem(A_dia, out["b"].gather().reshape(-1).double().cpu().numpy(),
                                    np.zeros(A_dia.n))
    solve_h, (bh, x0h) = make_shard_mgcg(sys_h, padded, mesh, policy, hierarchy=out["host_h"],
                                         dtype=dtype)
    out["host_res"], _ = _timed(lambda: solve_h(bh, x0h), dev)
    return out


def levels(h) -> list:
    """(grid, transfer, legs, where) of every level of a ``ShardHierarchy``."""
    return ([[list(L.grid), L.kind, len(L.op.shifts), "sharded"] for L in h.levels]
            + [[list(L.grid), L.transfer, len(L.A.shifts), "replicated"] for L in h.tail.levels])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--grid", type=int, nargs="+", default=[127, 127, 127])
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--dtype", choices=("float32", "float64"), default="float32")
    ap.add_argument("--probed-only", action="store_true", help="skip the host build and solves")
    ap.add_argument("--cpu", action="store_true", help="CPU shards: the kernels' twins")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("probed_setup_bench: no CUDA device (--cpu runs the twins)")
    dev = torch.device("cpu") if args.cpu else torch.device("cuda", 0)
    grid = tuple(args.grid)
    mesh = make_mesh(args.shards, devices=[dev] * args.shards)
    dtype = np.dtype(args.dtype)
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=500)
    out = (probed(grid, mesh, dtype) if args.probed_only
           else probed_vs_host(grid, mesh, pol, dtype))
    h = out["h"]
    rec = {
        "grid": list(grid), "padded": list(out["padded"]), "shards": args.shards,
        "dtype": args.dtype, "device": "cpu" if args.cpu else card_name(),
        "assembly_s": out["assembly_s"], "probed_setup_s": out["setup_s"],
        "probed_setup_by_phase": h.setup_s, "probed_host_reads": h.host_reads,
        "probed_levels": levels(h),
        "probed_near_null": [[list(g), q1, q2, kind] for g, q1, q2, kind in h.near_null],
    }
    if not args.probed_only:
        res, hh = out["res"], out["host_h"]
        s = generators.poisson_system(grid)
        x = res.x.gather().double().cpu().numpy()[:grid[0]].reshape(-1)
        rec.update({
            "host_setup_s": out["host_setup_s"], "host_setup_by_phase": hh.setup_s,
            "host_levels": [[list(L.grid), L.transfer, len(L.A.shifts)] for L in hh.levels],
            "probed_iterations": res.iterations, "host_iterations": out["host_res"].iterations,
            "probed_first_solve_s": out["solve_s"],
            "true_rel_residual": float(np.linalg.norm(s.b - oracle.spmv(s.A, x))
                                       / np.linalg.norm(s.b)),
            "converged": bool(res.converged and out["host_res"].converged),
        })
    print(json.dumps(rec))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
