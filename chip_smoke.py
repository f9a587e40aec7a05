#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the stencil kernels from ``conjugategradient_tpu_torch/csrc``, checks
each kernel against its plain PyTorch twin on the card, then drives the
port's main path through its public entry points: ``poisson_system`` ->
``build_hierarchy`` (rediscretized const-stencil levels, Chebyshev
pre=2/post=2) -> ``cg_solve`` with the V-cycle as preconditioner, on the 2-D
1023^2 and the 3-D 255^3 Poisson problems in fp32.  Every phase has a bound
and any miss, build failure or launch failure ends the run with a non-zero
exit before the last line.  The launch counters show that the solves went
through both kernels (the fused Chebyshev kernel at every 3-D level).

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel record (launches on the main path, worst error against the
twin, kernel and twin times).  Times come from CUDA events after a warm-up
and each is printed beside the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops import _build, cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    cheb_smooth_const_cuda,
    cheb_smooth_const_ref,
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
)
from conjugategradient_tpu_torch.precond.multigrid import (
    _const_bounds,
    as_preconditioner,
    build_hierarchy,
)
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: max |kernel - twin| <= KERNEL_REL * max |twin|: same leg order in fp32,
#: only FMA contraction differs.
KERNEL_REL = 1e-5
#: solver tolerance (rel_l2) and the bound on the true fp64 relative
#: residual of the fp32 solution (the fp32 drift floor).
TOL = 1e-6
TRUE_REL = 1e-5
#: card vs CPU solution of the same small solve: fp32 rounding differs
#: (FMA contraction, reduction order), the iterations are the same.
SMALL_AGREE = 1e-4

SEED = 0
GRID_2D = (1023, 1023)
GRID_3D = (255, 255, 255)
SPMV_GRIDS = [(1023, 1023), (37, 53), (255, 255, 255), (23, 9, 12)]
CHEB_GRIDS = [(24, 9, 12), (63, 63, 63), (255, 255, 255)]
SMALL_GRIDS = [(63, 63), (31, 31, 31)]
TIME_SPMV_GRIDS = [(1023, 1023), (255, 255, 255), (63, 63, 63)]
TIME_CHEB_GRIDS = [(255, 255, 255), (63, 63, 63)]

KERNELS = {
    "spmv_const_stencil": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:127",
    ),
    "cheb_smooth_const": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:288",
    ),
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _const_poisson(A_dia, grid):
    A = stencil_to_const(dia_to_stencil(A_dia, grid, copy=False))
    _require(A is not None, f"Poisson operator on {grid} is not a const stencil")
    return A


def _max_err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return err, scale


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call by CUDA events over ``reps`` calls after a warm-up."""
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


def _true_rel_residual(A, b, x) -> float:
    """||b - A x|| / ||b|| in fp64 on the card, through the plain twin."""
    b64, x64 = b.double(), x.double().reshape(b.shape)
    r = b64 - spmv_const_stencil_ref(A, x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def _mgcg(system, grid, device):
    """The main path: hierarchy setup, then MGCG through the public entry points."""
    t0 = time.perf_counter()
    h = build_hierarchy(
        system.A, grid, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
        coarse_operator=generators.poisson_coarse_operator(np.float32), device=device,
    )
    setup_s = time.perf_counter() - t0
    b = torch.from_numpy(system.b).to(device).reshape(grid)
    policy = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=8 * system.n)
    M = as_preconditioner(h)
    solve = lambda: cg_solve(h.levels[0].A, b, policy=policy, M=M, precise_dot=True)
    return h, b, solve, setup_s


def _check_solution(tag, A, b, res):
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    _require(tuple(res.x.shape) == tuple(b.shape), f"{tag}: x has shape {tuple(res.x.shape)}")
    _require(bool(torch.isfinite(res.x).all()), f"{tag}: x is not finite")
    rel = _true_rel_residual(A, b, res.x)
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    return rel


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {k: 0.0 for k in KERNELS}

    # -- phase 1: device ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(card)

    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {lib_path.name} in {time.perf_counter() - t0:.3f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")

    rng = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda g: torch.randn(g, generator=rng, device=dev, dtype=torch.float32)

    # -- phase 2: kernels vs twins on the card ------------------------------
    ops = {}
    for g in SPMV_GRIDS:
        A = _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
        ops[g] = A
        x = rand(g)
        err, scale = _max_err(spmv_const_stencil_cuda(A, x), spmv_const_stencil_ref(A, x))
        torch.cuda.synchronize()
        _require(err <= KERNEL_REL * scale, f"spmv {g}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
        errs["spmv_const_stencil"] = max(errs["spmv_const_stencil"], err)
        print(f"spmv_const_stencil {g}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
    for g in CHEB_GRIDS:
        A = ops.get(g) or _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
        ops[g] = A
        lo, hi = _const_bounds(A)
        invd = torch.tensor(1.0 / A.coeffs[A.shifts.index((0, 0, 0))], device=dev)
        b, x0 = rand(g), rand(g)
        for degree in (1, 2):
            for xin in (None, x0):
                for want_resid in (False, True):
                    args = (A, b, xin, degree, hi, lo, invd, want_resid)
                    err, scale = _max_err(cheb_smooth_const_cuda(*args), cheb_smooth_const_ref(*args))
                    torch.cuda.synchronize()
                    tag = (f"cheb {g} degree={degree} x0={'zero' if xin is None else 'given'} "
                           f"resid={want_resid}")
                    _require(err <= KERNEL_REL * scale, f"{tag}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
                    errs["cheb_smooth_const"] = max(errs["cheb_smooth_const"], err)
                    print(f"cheb_smooth_const {tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")

    # small solves on the card agree with the same solves on the CPU (twins)
    for g in SMALL_GRIDS:
        sys_ = generators.poisson_system(g, dtype=np.float32)
        _, b_gpu, solve_gpu, _ = _mgcg(sys_, g, dev)
        h_cpu, b_cpu, solve_cpu, _ = _mgcg(sys_, g, "cpu")
        r_gpu, r_cpu = solve_gpu(), solve_cpu()
        _check_solution(f"small MGCG {g}", h_cpu.levels[0].A, b_gpu, r_gpu)
        dx = float((r_gpu.x.cpu() - r_cpu.x).abs().max() / r_cpu.x.abs().max())
        _require(abs(r_gpu.iterations - r_cpu.iterations) <= 1,
                 f"small MGCG {g}: {r_gpu.iterations} iterations on the card vs {r_cpu.iterations} on the CPU")
        _require(dx <= SMALL_AGREE, f"small MGCG {g}: card vs CPU solution differs by {dx:.3e}")
        print(f"small MGCG {g}: card {r_gpu.iterations} its, CPU {r_cpu.iterations} its, "
              f"max rel diff {dx:.3e}")
    torch.cuda.synchronize()

    # -- phases 3-4: the main path, counted ---------------------------------
    sys2 = generators.poisson_system(GRID_2D, dtype=np.float32)
    sys3 = generators.poisson_system(GRID_3D, dtype=np.float32)
    h2, b2, solve2, setup2 = _mgcg(sys2, GRID_2D, dev)
    h3, b3, solve3, setup3 = _mgcg(sys3, GRID_3D, dev)
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    res2 = solve2()
    res3 = solve3()
    torch.cuda.synchronize()
    launches = {
        "spmv_const_stencil": spmv_const_stencil_cuda.launches,
        "cheb_smooth_const": cheb_smooth_const_cuda.launches,
    }
    by_grid = dict(cheb_smooth_const_cuda.launches_by_grid)

    rel2 = _check_solution("MGCG 2-D", h2.levels[0].A, b2, res2)
    rel3 = _check_solution("MGCG 3-D", h3.levels[0].A, b3, res3)
    print(f"MGCG 2-D {GRID_2D}: {res2.iterations} iterations, rel_l2 {float(res2.residual):.3e}, "
          f"true fp64 rel residual {rel2:.3e}, levels {[l.grid for l in h2.levels]} + "
          f"coarse {h2.coarse_inv.shape[0]}, setup {setup2:.2f} s")
    print(f"MGCG 3-D {GRID_3D}: {res3.iterations} iterations, rel_l2 {float(res3.residual):.3e}, "
          f"true fp64 rel residual {rel3:.3e}, levels {[l.grid for l in h3.levels]} + "
          f"coarse {h3.coarse_inv.shape[0]}, setup {setup3:.2f} s")

    # -- phase 5: path proof ------------------------------------------------
    for name, count in launches.items():
        _require(count > 0, f"{name}: no launch on the main path")
    for lvl in h3.levels:
        _require(by_grid.get(lvl.grid, 0) > 0, f"cheb_smooth_const: no launch at 3-D level {lvl.grid}")
    print(f"launches on the main path: {launches}; fused Chebyshev by grid: "
          f"{ {str(k): v for k, v in sorted(by_grid.items(), reverse=True)} }")

    # plain CG on the 2-D system, for comparison
    policy2 = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=8 * sys2.n)
    plain = lambda: cg_solve(h2.levels[0].A, b2, policy=policy2, precise_dot=True)
    res_plain = plain()
    rel_plain = _check_solution("plain CG 2-D", h2.levels[0].A, b2, res_plain)
    print(f"plain CG 2-D {GRID_2D}: {res_plain.iterations} iterations, "
          f"true fp64 rel residual {rel_plain:.3e}")

    # -- phase 6: times -----------------------------------------------------
    times = {}
    for g in TIME_SPMV_GRIDS:
        A = ops[g]
        x = rand(g)
        reps = 200 if np.prod(g) < 2e6 else 50
        k_ms = _time_ms(lambda: spmv_const_stencil_cuda(A, x), reps)
        p_ms = _time_ms(lambda: spmv_const_stencil_ref(A, x), reps)
        times[("spmv_const_stencil", g)] = (k_ms, p_ms)
        print(f"time spmv_const_stencil {g}: kernel {k_ms:.4f} ms, twin {p_ms:.4f} ms [{card}]")
    for g in TIME_CHEB_GRIDS:
        A = ops[g]
        lo, hi = _const_bounds(A)
        invd = torch.tensor(1.0 / A.coeffs[A.shifts.index((0, 0, 0))], device=dev)
        b, x0 = rand(g), rand(g)
        reps = 200 if np.prod(g) < 2e6 else 20
        for label, xin, want_resid in (("pre: zero x0 + resid", None, True),
                                       ("post: given x0", x0, False)):
            args = (A, b, xin, 2, hi, lo, invd, want_resid)
            k_ms = _time_ms(lambda: cheb_smooth_const_cuda(*args), reps)
            p_ms = _time_ms(lambda: cheb_smooth_const_ref(*args), reps)
            times[("cheb_smooth_const", g, label)] = (k_ms, p_ms)
            print(f"time cheb_smooth_const {g} degree 2 {label}: kernel {k_ms:.4f} ms, "
                  f"twin {p_ms:.4f} ms [{card}]")
    for tag, fn in (("MGCG 2-D", solve2), ("MGCG 3-D", solve3), ("plain CG 2-D", plain)):
        ms = _time_ms(fn, 3)
        print(f"time {tag} solve: {ms:.3f} ms [{card}]")

    # -- record -------------------------------------------------------------
    main_shape = {"spmv_const_stencil": ("spmv_const_stencil", GRID_3D),
                  "cheb_smooth_const": ("cheb_smooth_const", GRID_3D, "pre: zero x0 + resid")}
    record = [
        dict(name=name, **meta, launches=launches[name], max_abs_err=errs[name],
             ms=times[main_shape[name]][0], plain_ms=times[main_shape[name]][1])
        for name, meta in KERNELS.items()
    ]
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
