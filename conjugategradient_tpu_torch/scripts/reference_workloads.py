"""Run every reference driver workload end to end: the port's twin of
``examples/reference_workloads.py``.

    python -m conjugategradient_tpu_torch.scripts.reference_workloads \
        [--cpu] [--quick] [--only NAME] [--json PATH] [--fp32]

For each of the reference's drivers (``models.WORKLOADS``, the config ladder
left out): build the exact system, solve it with the port, solve it with the
fp64 host oracle (``core.oracle.cg``, standing in for the JAX package's
``native.cg``), validate element-wise with the reference's own 1% rule
(``Mgcg/cuBlas/Mgcg/MgcgMain.cs:129-140``) and print the phase timings in
the reference's formats (``utils.PhaseTimer``).

The solve runs on the card (``--cpu``: on the CPU, through the kernels'
twins) as plain fp64 CG, the JAX example's branch for a device with fp64;
``--fp32`` runs its other branch, mixed-precision refinement with fp32 inner
solves (``refined_solve``; the tridiagonal through a 1-D MGCG inner solver).
``--quick`` scales each n down to ``QUICK_SIZES``.  Beside the recursive
residual that decides convergence, each row carries the true fp64 residual
of the returned x: for simple_cuda (b_i = i^2/2) an absolute 1e-8 is below
fp64's reach at the reference's n (about 4e-20 of ||b||_2), so plain fp64
CG can only claim it through its recurrence.  Exit code 0 when every row is
OK.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np
import torch

QUICK_SIZES = {
    "cublas_flagship": 10_368,
    "handmade_cl": 17_280,
    "simple_cuda": 4_096,
    "viennacl_small": 10,
    "viennacl_large": 8_640,
    "r_prototype": 21,
}


def _true_residual(A, b, x0, x, norm: str) -> float:
    """The workload's norm of b - A x in fp64 by the host oracle (rel_l2:
    against ||b - A x0||_2, as the solver's convention)."""
    from conjugategradient_tpu_torch.core import oracle

    r = b - oracle.spmv(A, x)
    if norm == "linf":
        return float(np.max(np.abs(r)))
    if norm == "rel_l2":
        return float(np.linalg.norm(r) / np.linalg.norm(b - oracle.spmv(A, x0)))
    return float(np.linalg.norm(r))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="solve on the CPU (the kernels' twins)")
    ap.add_argument("--quick", action="store_true", help="the reduced sizes of QUICK_SIZES")
    ap.add_argument("--only", default=None, help="one workload by name")
    ap.add_argument("--json", default=None, help="write per-workload phase rows as a JSON artifact")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 inner solves with fp64 refinement (refined_solve)")
    args = ap.parse_args(argv)

    from conjugategradient_tpu_torch.core import oracle
    from conjugategradient_tpu_torch.core.formats import default_device
    from conjugategradient_tpu_torch.models.workloads import WORKLOADS
    from conjugategradient_tpu_torch.solvers.cg import cg_solve
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
    from conjugategradient_tpu_torch.utils import PhaseTimer

    device = default_device("cpu" if args.cpu else None)
    dtype = np.float32 if args.fp32 else np.float64
    platform = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"backend={device.type} ({platform}) dtype={np.dtype(dtype).name} "
          f"sizes={'quick' if args.quick else 'reference-exact'}")

    failures = 0
    rows = []
    for name, w in WORKLOADS.items():
        if name.startswith("ladder_"):
            continue  # the config ladder is the MGCG paths' business
        if args.only and name != args.only:
            continue
        if args.quick:
            w = dataclasses.replace(w, n=QUICK_SIZES[name])
        pol = w.policy

        t = PhaseTimer()
        with t.phase("build"):
            system = w.build(dtype=np.float64)
        with t.phase("oracle"):
            ref = oracle.cg(system.A, system.b, system.x0, tol=pol.tol, norm=pol.norm,
                            min_iteration=pol.min_iteration, max_iteration=4 * system.n,
                            raise_on_divergence=False)
        if args.fp32:
            from conjugategradient_tpu_torch.solvers.refine import refined_solve

            # the 2^16 tridiagonal (kappa ~ 1.7e9) gets a 1-D MGCG inner
            # solver, as in the JAX example
            mg_grid = (system.n,) if w.builder == "tridiagonal" else None
            with t.phase("solve"):
                rres = refined_solve(system.A, system.b, system.x0, tol=pol.tol, norm=pol.norm,
                                     inner_tol=1e-4, device_dtype=np.float32, grid=mg_grid,
                                     device=device)
            x_dev = rres.x
            it = rres.inner_iterations
            # a stalled refinement stopped at the fp64 residual-evaluation
            # noise floor; the element-wise check below is the arbiter
            converged = rres.converged or rres.stalled
            residual = rres.residual
            extra = f"{rres.outer_iterations} outer" + (" (noise floor)" if rres.stalled else "")
        else:
            with t.phase("input", sync=lambda: (A, b, x0)):
                A = system.A.device_put(dtype=dtype, device=device)
                b = torch.from_numpy(system.b.astype(dtype)).to(device)
                x0 = torch.from_numpy(system.x0.astype(dtype)).to(device)
            policy = ConvergencePolicy(tol=pol.tol, norm=pol.norm,
                                       min_iteration=pol.min_iteration,
                                       max_iteration=4 * system.n)
            with t.phase("first", sync=lambda: res):
                res = cg_solve(A, b, x0, policy)
            with t.phase("solve", sync=lambda: res):
                res = cg_solve(A, b, x0, policy)
            with t.phase("output"):
                x_dev = res.x.cpu().numpy().astype(np.float64)
            it = res.iterations
            converged = res.converged
            residual = float(res.residual)
            extra = ""
        true_res = _true_residual(system.A, system.b, system.x0, x_dev, pol.norm)
        # the reference's own validation: element-wise relative error > 1% flags
        denom = np.maximum(np.abs(ref.x), 1e-3 * np.max(np.abs(ref.x)) + 1e-300)
        rel = np.max(np.abs(x_dev - ref.x) / denom)
        stalled = "noise floor" in extra
        ok = converged and rel < 1e-2
        failures += 0 if ok else 1
        label = "OK*" if (ok and stalled) else ("OK " if ok else "MISMATCH")
        print(f"[{name:16s}] n={system.n:>8d} {label} "
              f"dev {it:6d} it {extra} (res {residual:.2e}, true {true_res:.2e}, norm {pol.norm}, "
              f"tol {pol.tol:g}) | oracle {ref.iterations:6d} it | rel err {rel:.2e}")
        print(f"  {t.report(iterations=it)}")
        rows.append({
            "workload": name, "n": int(system.n), "ok": bool(ok),
            "stalled_at_noise_floor": stalled,
            "iterations": int(it), "oracle_iterations": int(ref.iterations),
            "residual": float(residual), "true_residual": true_res,
            "true_residual_meets_tol": bool(true_res < pol.tol),
            "norm": pol.norm, "tol": pol.tol,
            "max_elementwise_rel_err": float(rel),
            # the reference's own input/exec/output split
            # (Mgcg/ViennaCL/MgcgCL/MgcgCLMain.cs:116-134)
            "phases_ms": {p.name: round(p.seconds * 1e3, 2) for p in t.phases},
        })
    print("ALL OK" if failures == 0 else f"{failures} MISMATCHES")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                "platform": platform,
                "dtype": np.dtype(dtype).name,
                "sizes": "quick" if args.quick else "reference-exact",
                "validation": "elementwise rel err < 1% vs the fp64 host oracle "
                              "(MgcgMain.cs:129-140 rule)",
                "rows": rows,
            }, f, indent=1)
        print(f"wrote {args.json}")
    return 0 if failures == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
