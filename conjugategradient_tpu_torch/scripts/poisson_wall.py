"""Wall time of the Poisson MGCG solves, to compare checkouts on one card.

    PYTHONPATH=<checkout> python <this file> [--reps 3]

Imports ``conjugategradient_tpu_torch`` from wherever ``PYTHONPATH`` points,
so one copy of this file times any checkout of the port: it calls only entry
points that every slice has kept (``generators.poisson_system``,
``precond.multigrid.build_hierarchy`` and ``as_preconditioner``,
``solvers.cg.cg_solve``, ``ConvergencePolicy``).  For the 1023^2 and 255^3
Poisson problems it builds ``chip_smoke.py``'s hierarchy (rediscretized
levels, Chebyshev pre = post = 2, fp32), solves once to warm up, times
``reps`` solves with CUDA events as ``chip_smoke.py``'s ``time MGCG`` lines
do, and profiles one solve with ``torch.profiler``: device time by kernel and
the device's busy share of the unprofiled wall.  Prints one JSON record per
grid.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner, build_hierarchy
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

GRIDS = ((1023, 1023), (255, 255, 255))


def _events_ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def measure(grid, reps: int) -> dict:
    s = generators.poisson_system(grid, dtype=np.float32)
    h = build_hierarchy(s.A, grid, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
                        coarse_operator=generators.poisson_coarse_operator(np.float32),
                        device="cuda")
    b = torch.from_numpy(s.b).to("cuda").reshape(grid)
    policy = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=8 * s.n)
    M = as_preconditioner(h)
    solve = lambda: cg_solve(h.levels[0].A, b, policy=policy, M=M, precise_dot=True)
    res = solve()
    ms = _events_ms(solve, reps)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        solve()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    device_ms = sum(r[0] for r in rows) / 1e3
    return {"grid": list(grid), "iterations": res.iterations, "solve_ms": ms,
            "device_ms": device_ms, "device_busy": device_ms / ms, "device_ops": sum(r[1] for r in rows),
            "profiled_wall_ms": prof_ms,
            "top": [[k[:70], round(us / 1e3, 4), n] for us, n, k in rows[:8]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("poisson_wall: needs a CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    for grid in GRIDS:
        print(json.dumps({"card": card, **measure(grid, args.reps)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
