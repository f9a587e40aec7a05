#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc`` per
source, started together), checks each kernel against its plain PyTorch twin
on the card, then drives the port's two main paths through their public
entry points, each with the launch counts set to 0 just before it and read
just after:

- MGCG: ``poisson_system`` -> ``build_hierarchy`` (rediscretized
  const-stencil levels, Chebyshev pre=2/post=2) -> ``cg_solve`` with the
  V-cycle as preconditioner, on the 2-D 1023^2 and the 3-D 255^3 Poisson
  problems in fp32.  The counts show both stencil kernels ran (the fused
  Chebyshev kernel at every 3-D level).
- The flagship: ``WORKLOADS["cublas_flagship"]`` (n = 207,402, band 160) in
  fp64 -> ``refined_solve`` to an absolute ||r||_2 < 1e-8, three times: fp32
  legs, bf16 legs (``matrix_dtype``) and the fp64 device residual
  (``device_residual=True``); then ``api.solve(A, B, method="refined")`` with
  an n x 4 block.  The counts show the DIA SpMV ran in each of its three
  instantiations and as often as the iteration counts imply, and that the
  DIA SpMM ran.

Every phase has a bound and any miss, build failure or launch failure ends
the run with a non-zero exit before the last line.  The last line is
``{"ok": true, "device": {...}}``; the line before it holds the per-kernel
record (launches on the main path, worst error against the twin, kernel and
twin times).  Times come from CUDA events after a warm-up and each is
printed beside the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.models.workloads import WORKLOADS
from conjugategradient_tpu_torch.ops import _build, cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_dia import (
    TAGS,
    k_chunks,
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
    spmv_dot_dia_ref,
)
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
from conjugategradient_tpu_torch.solvers.refine import refined_solve

#: max |kernel - twin| <= KERNEL_REL * max |twin|: same leg order in fp32
#: (or bf16 legs with fp32 accumulation), only FMA contraction differs.
KERNEL_REL = 1e-5
#: the same bound for the fp64 DIA instantiation.
KERNEL_REL64 = 1e-13
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

#: the flagship: fp64 contract, fp32 inner solves (bench.py's call)
FLAGSHIP = "cublas_flagship"
FLAGSHIP_TOL = 1e-8
FLAGSHIP_INNER_TOL = 1e-4
#: multi-RHS columns vs their single-RHS refined solves, and the card vs the
#: CPU on the small refined solve: both fp64-converged to ||r|| < 1e-8, so
#: the solutions agree far below fp32 rounding.
MULTI_AGREE = 1e-7
SMALL_REFINE = (4096, 32)
SPMM_KS = (1, 3, 4, 8)
DIA_LEGS = tuple(TAGS)

KERNELS = {
    "spmv_const_stencil": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:127",
    ),
    "cheb_smooth_const": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:288",
    ),
    "spmv_dia": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:193",
    ),
    "spmm_dia": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:421",
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


def _dia_cases(flagship_A):
    """(label, host DiaMatrix) of the DIA kernel checks: the flagship, a
    ragged band, the tridiagonal workload, and 2-D/3-D Poisson operators as
    flat DIA (far offsets +-1023 and +-3969)."""
    return [
        (f"banded_sin n={flagship_A.n} band=160", flagship_A),
        ("banded_sin n=333 band=8", generators.banded_sin_matrix(333, 8)),
        ("tridiagonal n=65536", generators.tridiagonal_matrix(65536)),
        ("poisson2d 1023^2", generators.poisson2d_matrix(1023)),
        ("poisson3d 63^3", generators.poisson3d_matrix(63)),
    ]


def _dia_kernel_checks(cases, dev, errs):
    """Kernel #4 (fp32, bf16 and fp64 legs; plain and fused) and kernel #5
    (k in SPMM_KS) against their twins; every SpMM column must equal the
    single-RHS kernel bit for bit (same legs, same order, explicit fma)."""
    rng = np.random.default_rng(SEED)
    for label, A_host in cases:
        for legs in DIA_LEGS:
            A = A_host.device_put(legs, dev)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            tag = f"{label} {TAGS[legs]} legs"
            x = torch.from_numpy(rng.standard_normal(A.n)).to(dev, vec)
            y, ref = spmv_dia_cuda(A, x), spmv_dia_ref(A, x)
            yf, dot = spmv_dot_dia_cuda(A, x)
            ref_dot = torch.dot(x, ref)
            torch.cuda.synchronize()
            err, scale = _max_err(y, ref)
            _require(err <= rel * scale, f"spmv_dia {tag}: max err {err:.3e} > {rel}*{scale:.3e}")
            _require(torch.equal(yf, y), f"spmv_dot_dia {tag}: fused A p differs from the SpMV's")
            dot_err = abs(float(dot) - float(ref_dot))
            dot_scale = float((x.abs() * ref.abs()).sum())
            _require(dot_err <= rel * dot_scale,
                     f"spmv_dot_dia {tag}: p.Ap err {dot_err:.3e} > {rel}*{dot_scale:.3e}")
            errs["spmv_dia"] = max(errs["spmv_dia"], err)
            print(f"spmv_dia {tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}); "
                  f"fused p.Ap err {dot_err:.3e} (sum|p Ap| {dot_scale:.3e})")
            if legs == torch.float64:
                continue
            worst = 0.0
            for k in SPMM_KS:
                X = torch.from_numpy(rng.standard_normal((k, A.n))).to(dev, torch.float32)
                Y, ref = spmm_dia_cuda(A, X), spmm_dia_ref(A, X)
                torch.cuda.synchronize()
                err, scale = _max_err(Y, ref)
                _require(err <= KERNEL_REL * scale,
                         f"spmm_dia {tag} k={k}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
                same = all(torch.equal(Y[j], spmv_dia_cuda(A, X[j])) for j in range(k))
                _require(same, f"spmm_dia {tag} k={k}: a column differs from the single-RHS kernel")
                worst = max(worst, err)
            errs["spmm_dia"] = max(errs["spmm_dia"], worst)
            print(f"spmm_dia {tag} k={SPMM_KS}: max|kernel-twin| {worst:.3e}; "
                  "every column equals the SpMV kernel's")


def _small_refine_card_vs_cpu(dev):
    """The same small refined solve on the card and on the CPU (twins)."""
    s = generators.banded_sin_system(*SMALL_REFINE)
    kw = dict(tol=FLAGSHIP_TOL, norm="l2", inner_tol=FLAGSHIP_INNER_TOL)
    g = refined_solve(s.A, s.b, s.x0, device=dev, **kw)
    c = refined_solve(s.A, s.b, s.x0, device="cpu", **kw)
    tag = f"small refined banded_sin{SMALL_REFINE}"
    _require(g.converged and c.converged, f"{tag}: card {g.converged}, CPU {c.converged}")
    _require(g.outer_iterations == c.outer_iterations,
             f"{tag}: {g.outer_iterations} outer passes on the card vs {c.outer_iterations} on the CPU")
    dx = float(np.abs(g.x - c.x).max() / np.abs(c.x).max())
    _require(dx <= MULTI_AGREE, f"{tag}: card vs CPU solution differs by {dx:.3e}")
    print(f"{tag}: card {g.outer_iterations} outer / {g.inner_iterations} inner, CPU "
          f"{c.outer_iterations} / {c.inner_iterations}, max rel diff {dx:.3e}")


def _flagship_routes(fsys, dev, card):
    """bench.py's flagship call on the card, three routes, each counted (the
    counts set to 0 just before the solve and read just after) and then
    timed in a second run.  Returns {route: launches by dtype}."""
    routes = (
        ("fp32 legs", {}, "fp32"),
        ("bf16 legs", dict(matrix_dtype=torch.bfloat16), "bf16"),
        ("fp64 device residual", dict(device_residual=True), "fp32"),
    )
    out = {}
    for label, kw, inner_tag in routes:
        solve = lambda: refined_solve(
            fsys.A, fsys.b, fsys.x0, tol=FLAGSHIP_TOL, norm="l2", inner_tol=FLAGSHIP_INNER_TOL,
            device_dtype=np.float32, device=dev, **kw)
        torch.cuda.synchronize()
        cuda_dia.reset_launch_counts()
        res = solve()
        torch.cuda.synchronize()
        counts = dict(spmv_dia_cuda.launches_by_dtype)
        tag = f"flagship {label}"
        _require(res.converged, f"{tag}: not converged after {res.outer_iterations} passes "
                                f"(stalled {res.stalled}, history {res.history})")
        _require(res.x.shape == (fsys.n,) and bool(np.isfinite(res.x).all()), f"{tag}: bad x")
        r_true = float(np.linalg.norm(fsys.b - oracle.spmv(fsys.A, res.x)))
        _require(r_true < FLAGSHIP_TOL, f"{tag}: true fp64 ||b - A x||_2 {r_true:.3e} >= {FLAGSHIP_TOL}")
        want = res.outer_iterations + res.inner_iterations
        _require(want > 0, f"{tag}: no inner solve ran")
        _require(counts.get(inner_tag, 0) == want,
                 f"{tag}: {inner_tag} SpMV launches {counts} != outer + inner iterations {want}")
        if kw.get("device_residual"):
            _require(counts.get("fp64", 0) == res.outer_iterations + 1,
                     f"{tag}: fp64 residual launches {counts} != outer passes + 1")
        print(f"{tag}: converged, {res.outer_iterations} outer / {res.inner_iterations} inner "
              f"iterations, true fp64 ||r||_2 {r_true:.3e}, history "
              f"{[float(f'{h:.4e}') for h in res.history]}, spmv_dia launches {counts}")
        _print_route_time(f"{tag} (counted run)", res.timings, card)
        _print_route_time(f"{tag} (timed run)", solve().timings, card)
        out[label] = counts
    return out


def _print_route_time(tag, timings, card):
    """A refined solve's host-clock wall (the whole call) split into inner
    solves and host outer work, from ``RefineResult.timings``."""
    wall = timings["inner_s"] + timings["outer_s"]
    print(f"time {tag}: wall {wall * 1e3:.3f} ms = inner solves {timings['inner_s'] * 1e3:.3f} ms"
          f" + host outer work {timings['outer_s'] * 1e3:.3f} ms; timings "
          f"{({k: round(v * 1e3, 3) for k, v in timings.items()})} ms [{card}]")


def _flagship_multi(fsys, dev, card) -> int:
    """``api.solve(A, B, method="refined")`` with B = [b, three seeded normal
    columns], counted; every column must converge and agree with its
    single-RHS refined solve.  Returns the SpMM launch count."""
    rng = np.random.default_rng(SEED)
    B = np.column_stack([fsys.b] + [rng.standard_normal(fsys.n) for _ in range(3)])
    torch.cuda.synchronize()
    cuda_dia.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.solve(fsys.A, B, method="refined", tol=FLAGSHIP_TOL, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm_dia_cuda.launches
    by_dtype = dict(spmm_dia_cuda.launches_by_dtype)
    tag = f"flagship multi-RHS n x {B.shape[1]}"
    _require(bool(res.converged.all()), f"{tag}: converged {res.converged}, history {res.history}")
    _require(res.x.shape == B.shape and bool(np.isfinite(res.x).all()), f"{tag}: bad X")
    _require(launches > 0, f"{tag}: no spmm_dia launch")
    worst = 0.0
    for j in range(B.shape[1]):
        r_true = float(np.linalg.norm(B[:, j] - oracle.spmv(fsys.A, res.x[:, j])))
        _require(r_true < FLAGSHIP_TOL, f"{tag} column {j}: true ||r||_2 {r_true:.3e}")
        single = refined_solve(fsys.A, B[:, j], tol=FLAGSHIP_TOL, device=dev)
        dx = float(np.abs(res.x[:, j] - single.x).max() / np.abs(single.x).max())
        _require(dx <= MULTI_AGREE, f"{tag} column {j}: differs from its single-RHS solve by {dx:.3e}")
        worst = max(worst, dx)
    print(f"{tag}: converged in {res.outer_iterations} outer passes, inner iterations per column "
          f"{res.inner_iterations.tolist()}, max rel diff to single-RHS solves {worst:.3e}, "
          f"spmm_dia launches {launches} {by_dtype} (chunks of {k_chunks(B.shape[1])})")
    print(f"time {tag}: wall {wall * 1e3:.3f} ms [{card}]")
    return launches


def _dia_times(A_host, dev, card, times):
    """Kernel vs twin at the flagship's shape (band 160, n = 207,402): the
    SpMV in three instantiations, fused vs unfused-plus-dot, the SpMM at
    k = 4 and 8 vs k single SpMVs; and a read/copy bandwidth canary."""
    rng = np.random.default_rng(SEED + 1)
    n = A_host.n
    xs = {v: torch.from_numpy(rng.standard_normal(n)).to(dev, v) for v in (torch.float32, torch.float64)}
    for legs in DIA_LEGS:
        A = A_host.device_put(legs, dev)
        x = xs[torch.float64 if legs == torch.float64 else torch.float32]
        k_ms = _time_ms(lambda: spmv_dia_cuda(A, x), 200)
        p_ms = _time_ms(lambda: spmv_dia_ref(A, x), 10)
        gb = (A.data.numel() * A.data.element_size() + 2 * n * x.element_size()) / 1e9
        times[("spmv_dia", TAGS[legs])] = (k_ms, p_ms)
        print(f"time spmv_dia {TAGS[legs]} legs n={n} band=160: kernel {k_ms:.4f} ms "
              f"({gb / (k_ms * 1e-3):.0f} GB/s of {gb * 1e3:.1f} MB), twin {p_ms:.4f} ms [{card}]")
    A = A_host.device_put(torch.float32, dev)
    x = xs[torch.float32]
    f_ms = _time_ms(lambda: spmv_dot_dia_cuda(A, x), 200)
    u_ms = _time_ms(lambda: torch.dot(x, spmv_dia_cuda(A, x)), 200)
    print(f"time spmv_dot_dia fp32 fused: {f_ms:.4f} ms vs unfused SpMV + dot {u_ms:.4f} ms [{card}]")
    for k in (4, 8):
        X = torch.from_numpy(rng.standard_normal((k, n))).to(dev, torch.float32)
        k_ms = _time_ms(lambda: spmm_dia_cuda(A, X), 100)
        s_ms = _time_ms(lambda: [spmv_dia_cuda(A, X[j]) for j in range(k)], 100)
        p_ms = _time_ms(lambda: spmm_dia_ref(A, X), 5)
        times[("spmm_dia", k)] = (k_ms, p_ms)
        print(f"time spmm_dia fp32 k={k}: kernel {k_ms:.4f} ms vs {k} single SpMVs {s_ms:.4f} ms, "
              f"twin {p_ms:.4f} ms [{card}]")
    buf = torch.empty(A.data.numel(), dtype=torch.float32, device=dev).normal_()
    gb = buf.numel() * 4 / 1e9
    r_ms = _time_ms(lambda: buf.sum(), 100)
    c_ms = _time_ms(lambda: buf.clone(), 100)
    print(f"canary {gb * 1e3:.1f} MB fp32: read (sum) {r_ms:.4f} ms = {gb / (r_ms * 1e-3):.0f} GB/s, "
          f"copy {c_ms:.4f} ms = {2 * gb / (c_ms * 1e-3):.0f} GB/s [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {k: 0.0 for k in KERNELS}
    t_run = time.perf_counter()

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
    lib_paths = _build.build()
    for name in lib_paths:
        _build.load(name)
    print(f"build: {sorted(p.name for p in lib_paths.values())} in {time.perf_counter() - t0:.3f} s")
    for lib_path in lib_paths.values():
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

    # DIA kernels (#4 in three instantiations and fused, #5) vs their twins
    t0 = time.perf_counter()
    fsys = WORKLOADS[FLAGSHIP].build(dtype=np.float64)
    print(f"flagship system {FLAGSHIP}: n {fsys.n}, {fsys.A.ndiags} diagonals, "
          f"built in {time.perf_counter() - t0:.3f} s")
    _dia_kernel_checks(_dia_cases(fsys.A), dev, errs)
    _small_refine_card_vs_cpu(dev)

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

    # -- the flagship path, counted: three refined routes, then multi-RHS ----
    flag = _flagship_routes(fsys, dev, card)
    multi_spmm = _flagship_multi(fsys, dev, card)
    launches["spmv_dia"] = sum(sum(c.values()) for c in flag.values())
    launches["spmm_dia"] = multi_spmm

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
    _dia_times(fsys.A, dev, card, times)

    # -- record -------------------------------------------------------------
    main_shape = {"spmv_const_stencil": ("spmv_const_stencil", GRID_3D),
                  "cheb_smooth_const": ("cheb_smooth_const", GRID_3D, "pre: zero x0 + resid"),
                  "spmv_dia": ("spmv_dia", "fp32"),
                  "spmm_dia": ("spmm_dia", 4)}
    record = [
        dict(name=name, **meta, launches=launches[name], max_abs_err=errs[name],
             ms=times[main_shape[name]][0], plain_ms=times[main_shape[name]][1])
        for name, meta in KERNELS.items()
    ]
    print(f"run: {time.perf_counter() - t_run:.1f} s after the build")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
