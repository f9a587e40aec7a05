"""Multi-process distributed solve: N OS processes, one global mesh.

The port's twin of ``examples/multiprocess_demo.py``.  The launcher starts
``--procs`` separate interpreters, each of which

- joins one ``torch.distributed`` process group
  (``multihost.initialize_distributed`` with an explicit coordinator,
  ``strict=True``);
- builds the global 1-D mesh over every process's ``--local-devices``
  shards (``multihost.global_mesh``): ``["cpu"] * L`` with ``--device
  cpu``, ``["cuda:<rank % cards>"] * L`` with ``--device cuda``;
- assembles ``--workload`` straight onto its own shards
  (``multihost.make_distributed_system``: each process generates only its
  row blocks) and runs the sharded CG (``parallel.sharded_cg``: kernel #4 on
  each shard, the dots ``psum``'d and the halos ``ppermute``'d across the
  process boundary);
- validates its OWN shards element-wise against the fp64 oracle
  (``core.oracle.cg``; no global gather), to 1e-6 relative.

With ``--mgcg`` it also runs rung 5 across processes: the Poisson
``--grid``³ system assembled slab by slab onto the shards
(``rung5.make_rung5_system``), its hierarchy probed on the shards
(``precond.distributed.build_hierarchy_probed``, kernel #3 a shard) and
the sharded MGCG (``rung5.make_rung5_mgcg``), which must converge.
``--routes`` adds the other routes held across processes: CG's ``cg1``,
``pipelined`` and ``cacg`` variants, the all-gather product, rung 5's
plain CG, ``shard_mgcg_solve`` on a host-built hierarchy and the
rediscretized multigrid BiCGStab on convection-diffusion.

``--backend`` is the group's (default: NCCL for ``--device cuda``, Gloo for
``--device cpu``).  NCCL refuses two ranks on one GPU, so two ranks on one
card take ``--backend gloo``, which stages every transfer through host
buffers.  ``--device cuda`` without a CUDA device raises.

Usage:

    python -m conjugategradient_tpu_torch.scripts.multiprocess_demo               # CPU, CG
    python -m conjugategradient_tpu_torch.scripts.multiprocess_demo --mgcg --local-devices 2
    python -m conjugategradient_tpu_torch.scripts.multiprocess_demo --device cuda \\
        --backend gloo --local-devices 2 --mgcg --grid 255      # two ranks on one card

Each worker prints its results, its kernel #3/#4 launch counts and its
seconds (assembly, setup, warm solve, inside the communicator) on a
``worker {json}`` line, and with ``--out DIR`` saves them with its owned
parts of every solution to ``DIR/rank<r>.pt``.  The launcher prints one
JSON verdict line and exits 0 iff every worker validated OK in time.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.models import get
from conjugategradient_tpu_torch.ops import cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.parallel import multihost, rung5
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    all_gather,
    pmax,
    ppermute,
    psum,
    shard_rows,
)
from conjugategradient_tpu_torch.parallel.shard_mgcg import shard_mgcg_solve
from conjugategradient_tpu_torch.parallel.sharded_cg import make_sharded_cg
from conjugategradient_tpu_torch.precond.distributed import (
    build_hierarchy_probed,
    build_hierarchy_redisc,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: the environment variables that set numpy's BLAS and OpenMP threads
BLAS_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")

#: the JAX demo's policies: CG to rel_l2 1e-9, MGCG to 1e-5
CG_POLICY = ConvergencePolicy(tol=1e-9, norm="rel_l2", max_iteration=20000)
MGCG_POLICY = ConvergencePolicy(tol=1e-5, norm="rel_l2", max_iteration=200)
#: the oracle's tolerance and the own-shard check's
ORACLE_TOL = 1e-11
SHARD_TOL = 1e-6
#: ``--routes``: the all-gather system (bandwidth past a shard's rows), the
#: shard_mgcg grid and the convection grid and its diffusion
AG_SYSTEM = (128, 40)
SMG_GRID = (64, 64)
CONV_GRID = (16, 16, 16)
CONV_EPS = 0.05


def _sync(mesh: Mesh) -> None:
    for d in set(mesh.local_devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _counts() -> dict:
    """Kernel #4's launches (plain and fused) and #3's (tuned, wide) in
    this process since the last reset."""
    return {"spmv_dia": cuda_dia.spmv_dia_cuda.launches + cuda_dia.spmv_dot_dia_cuda.launches,
            "spmv_stencil": cuda_stencil.spmv_stencil_cuda.launches,
            "spmv_stencil_wide": cuda_stencil.spmv_stencil_wide_cuda.launches}


def _reset(mesh: Mesh) -> None:
    _sync(mesh)
    cuda_dia.reset_launch_counts()
    cuda_stencil.reset_launch_counts()


def _host(x: Shards) -> list:
    return [p.detach().cpu() for p in x.parts]


def _owned(mesh: Mesh, x) -> Shards:
    """A solve's x as this process's row blocks: a one-process mesh's
    solvers return the gathered vector, a multi-process mesh's the
    ``Shards``."""
    return x if isinstance(x, Shards) else shard_rows(mesh, x)


def shards_match(x: Shards, ref: np.ndarray, n_local: int) -> float:
    """The worst relative error of this process's own row blocks of ``x``
    against the global fp64 reference ``ref``: max |got - want| / max |want|
    a block."""
    worst = 0.0
    for i, part in zip(x.mesh.owned, x.parts):
        want = ref[i * n_local:(i + 1) * n_local]
        got = part.detach().cpu().double().numpy()
        denom = max(1e-30, float(np.abs(want).max())) if want.size else 1.0
        worst = max(worst, float(np.abs(got - want).max()) / denom)
    return worst


def run_cg(mesh: Mesh, workload: str, policy: ConvergencePolicy = CG_POLICY) -> dict:
    """The CG half: assembly on the owned shards, the sharded CG (fp64),
    each owned block against the fp64 oracle."""
    _sync(mesh)
    t0 = time.perf_counter()
    A, b, x0, n = multihost.make_distributed_system(workload, mesh, dtype=np.float64)
    _sync(mesh)
    t_asm = time.perf_counter() - t0
    solve = make_sharded_cg(A, mesh, policy)
    _reset(mesh)
    comm0 = mesh.comm.seconds if mesh.comm is not None else 0.0
    t0 = time.perf_counter()
    res = solve(A.data, b, x0)
    _sync(mesh)
    wall = time.perf_counter() - t0
    counts = _counts()
    comm = (mesh.comm.seconds - comm0) if mesh.comm is not None else 0.0
    s = get(workload).build(dtype=np.float64)
    ores = oracle.cg(s.A, np.asarray(s.b), np.asarray(s.x0), tol=ORACLE_TOL,
                     max_iteration=policy.max_iteration, norm=policy.norm)
    ref = np.zeros(A.n)
    ref[:n] = ores.x
    x = _owned(mesh, res.x)
    err = shards_match(x, ref, A.n // mesh.size)
    return dict(workload=workload, n=n, n_padded=A.n, iterations=res.iterations,
                converged=res.converged, residual=float(res.residual),
                oracle_iterations=ores.iterations, worst_rel_err=err, ok=bool(res.converged) and err < SHARD_TOL, x=_host(x),
                counts=counts, assembly_s=t_asm, solve_s=wall, comm_s=comm)


def run_mgcg(mesh: Mesh, grid: int, reps: int = 1, policy: ConvergencePolicy = MGCG_POLICY) -> dict:
    """The rung-5 half: Poisson ``grid``³ assembled onto the shards in fp32,
    its hierarchy probed on them, the sharded MGCG (``reps`` solves, the
    last timed warm)."""
    g = (int(grid),) * 3
    _sync(mesh)
    t0 = time.perf_counter()
    A, b, x0, padded, n_real = rung5.make_rung5_system(g, mesh, dtype=np.float32)
    _sync(mesh)
    t_asm = time.perf_counter() - t0
    _reset(mesh)
    t0 = time.perf_counter()
    h = build_hierarchy_probed(A, mesh, max_coarse=1025)
    _sync(mesh)
    t_setup = time.perf_counter() - t0
    setup_counts = _counts()
    solve = rung5.make_rung5_mgcg(policy, h)
    walls, comms, counts = [], [], None
    for _ in range(max(1, int(reps))):
        _reset(mesh)
        comm0 = mesh.comm.seconds if mesh.comm is not None else 0.0
        t0 = time.perf_counter()
        res = solve(b, x0)
        _sync(mesh)
        walls.append(time.perf_counter() - t0)
        comms.append((mesh.comm.seconds - comm0) if mesh.comm is not None else 0.0)
        counts = counts or _counts()
    sweeps = lambda k: 0 if k <= 0 else {"chebyshev": 1 + k}.get(h.smoother, k)  # noqa: E731
    tail = sum(sweeps(h.pre) + sweeps(h.post) + 1 for _ in h.tail.levels)
    return dict(grid=g, padded=padded, n_real=n_real, iterations=res.iterations,
                converged=res.converged, residual=float(res.residual), ok=bool(res.converged),
                x=_host(res.x), real0=h.real0, n_sharded=len(h.levels),
                products_per_cycle=solve.plan.products_per_cycle, tail_products=tail,
                setup_products=[(tuple(gg), s, p) for gg, s, p in h.setup_products],
                setup_counts=setup_counts, counts=counts, assembly_s=t_asm, setup_s=t_setup,
                solve_s=walls, comm_s=comms)


def run_routes(mesh: Mesh) -> dict:
    """The other routes held across processes, each one solve: its count
    and this process's parts of x."""
    out = {}
    A, b, x0, n = multihost.make_distributed_system("ladder_dense_1k", mesh, dtype=np.float64)
    for variant in ("cg1", "pipelined", "cacg"):
        res = make_sharded_cg(A, mesh, CG_POLICY, variant=variant)(A.data, b, x0)
        out[f"cg {variant}"] = (res.iterations, _host(_owned(mesh, res.x)))
    s = generators.banded_sin_system(*AG_SYSTEM)
    res = make_sharded_cg(s.A, mesh, CG_POLICY)(shard_rows(mesh, s.A.data), shard_rows(mesh, s.b),
                                                shard_rows(mesh, s.x0))
    out["cg all-gather"] = (res.iterations, _host(_owned(mesh, res.x)))
    A5, b5, x05, _, _ = rung5.make_rung5_system((15, 15, 15), mesh, dtype=np.float64)
    res = rung5.make_rung5_cg(ConvergencePolicy(tol=1e-10, norm="rel_l2"))(A5, b5, x05)
    out["rung5 cg"] = (res.iterations, _host(res.x))
    sp = generators.poisson_system(SMG_GRID)
    res = shard_mgcg_solve(sp, SMG_GRID, mesh, ConvergencePolicy(tol=1e-10, norm="rel_l2"))
    x = res.x.gather_grid(len(SMG_GRID)).reshape(-1) if isinstance(res.x, Shards) else res.x
    out["shard_mgcg"] = (res.iterations, _host(_owned(mesh, x)))
    Ac, bc, x0c = rung5.make_convection_system(CONV_GRID, mesh, eps=CONV_EPS, dtype=np.float64)
    hc = build_hierarchy_redisc(CONV_GRID, mesh,
                                generators.convection_diffusion_level_slab(CONV_EPS,
                                                                           dtype=np.float64),
                                max_coarse=1025, dtype=np.float64)
    res = rung5.make_rung5_mg_nonsym(ConvergencePolicy(tol=1e-8, norm="rel_l2",
                                                       max_iteration=200), hc)(bc, x0c)
    out["rung5 mg_bicgstab"] = (res.iterations, _host(res.x))
    return out


def run_collectives(mesh: Mesh) -> dict:
    """psum, pmax, both ppermute shifts and the gathers on the 1-D mesh,
    then the same on a (2, 2) mesh of its devices (rows of the mesh by
    process): shard i holds ``arange(3) + 10 i`` (fp64)."""
    def vals(m):
        return Shards([torch.arange(3, dtype=torch.float64, device=d) + 10.0 * i
                       for i, d in m.shards()], m)

    out = {}
    v = vals(mesh)
    out["psum"], out["pmax"] = psum(v).parts[0].cpu(), pmax(v).parts[0].cpu()
    for s in (1, -1):
        out[f"ppermute {s}"] = _host(ppermute(v, s))
    out["all_gather"] = all_gather(v).parts[0].cpu()
    out["gather"] = v.gather().cpu()
    if mesh.size == 4:
        m2 = Mesh([list(mesh.devices[:2]), list(mesh.devices[2:])], ("x", "y"), comm=mesh.comm)
        v2 = vals(m2)
        out["2d psum"] = psum(v2).parts[0].cpu()
        for ax in ("x", "y"):
            for s in (1, -1):
                out[f"2d ppermute {ax} {s}"] = _host(ppermute(v2, s, ax))
        out["2d gather"] = Shards.map(lambda t: t.reshape(1, 3), v2).gather((0, 1)).cpu()
    return out


# --------------------------------------------------------------------------
# worker
# --------------------------------------------------------------------------


def worker(args) -> int:
    if args.threads:
        torch.set_num_threads(args.threads)
    multihost.initialize_distributed(args.coordinator, args.procs, args.process_id, strict=True,
                                     backend=args.backend, timeout=args.timeout)
    import torch.distributed as dist

    pid, nproc = dist.get_rank(), dist.get_world_size()
    assert nproc == args.procs, (nproc, args.procs)
    dev = "cpu" if args.device == "cpu" else f"cuda:{pid % torch.cuda.device_count()}"
    mesh = multihost.global_mesh(devices=[dev] * args.local_devices)
    log = lambda msg: print(f"[proc {pid}/{nproc}] {msg}", flush=True)  # noqa: E731
    log(f"joined ({mesh.comm.backend}): {mesh.size} global shards, owned {list(mesh.owned)} on "
        f"{dev}")

    rec = dict(rank=pid, world=nproc, owned=list(mesh.owned), device=dev,
               backend=mesh.comm.backend)
    rec["collectives"] = run_collectives(mesh)
    cg = run_cg(mesh, args.workload)
    log(f"sharded CG '{cg['workload']}' n={cg['n']:,} (padded {cg['n_padded']:,}) across "
        f"processes: {cg['iterations']} iterations, residual {cg['residual']:.3e}, converged="
        f"{cg['converged']}; own shards against the fp64 oracle: worst rel err "
        f"{cg['worst_rel_err']:.3e} (tol {SHARD_TOL:g}); {'CG OK' if cg['ok'] else 'CG MISMATCH'}")
    rec["cg"] = cg
    ok = cg["ok"]
    if args.mgcg:
        mg = run_mgcg(mesh, args.grid, args.reps)
        log(f"rung-5 MGCG {mg['grid']} (padded {mg['padded']}): {mg['iterations']} iterations, "
            f"residual {mg['residual']:.3e}, converged={mg['converged']}; "
            f"{'MGCG OK' if mg['ok'] else 'MGCG FAIL (not converged)'}")
        rec["mgcg"] = mg
        ok = ok and mg["ok"]
    if args.routes:
        rec["routes"] = run_routes(mesh)
    rec["ok"] = ok
    summary = dict(rank=pid, ok=ok, cg=dict(iterations=cg["iterations"], counts=cg["counts"],
                                            assembly_s=cg["assembly_s"], solve_s=cg["solve_s"],
                                            comm_s=cg["comm_s"]))
    if args.mgcg:
        summary["mgcg"] = {k: rec["mgcg"][k] for k in ("iterations", "counts", "setup_counts",
                                                       "assembly_s", "setup_s", "solve_s",
                                                       "comm_s")}
    if args.device == "cuda":
        from conjugategradient_tpu_torch.ops.card import card_name

        summary["card"] = card_name()
    print("worker " + json.dumps(summary), flush=True)
    if args.out:
        torch.save(rec, os.path.join(args.out, f"rank{pid}.pt"))
    # no process tears the group down while a peer is still inside a
    # collective
    dist.barrier()
    dist.destroy_process_group()
    return 0 if ok else 1


# --------------------------------------------------------------------------
# launcher
# --------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker_command(args, coordinator: str, process_id: int) -> list:
    """The command line of worker ``process_id``: this module with the
    launcher's arguments and ``--worker``."""
    cmd = [sys.executable, "-m", "conjugategradient_tpu_torch.scripts.multiprocess_demo",
           "--worker", "--coordinator", coordinator, "--process-id", str(process_id),
           "--procs", str(args.procs), "--local-devices", str(args.local_devices),
           "--workload", args.workload, "--grid", str(args.grid), "--device", args.device,
           "--timeout", str(args.timeout), "--reps", str(args.reps), "--threads", str(args.threads),
           "--backend", args.backend]
    cmd += ["--out", args.out] if args.out else []
    cmd += ["--mgcg"] if args.mgcg else []
    cmd += ["--routes"] if args.routes else []
    return cmd


def launch(args) -> dict:
    """Start ``args.procs`` workers and wait for them, killing the rest once
    one fails or the deadline passes: the verdict record."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [REPO, env.get("PYTHONPATH")]))
    if args.threads:  # numpy's BLAS reads these when a worker imports it
        env.update(dict.fromkeys(BLAS_THREAD_VARS, str(args.threads)))
    procs = [subprocess.Popen(worker_command(args, coordinator, i), env=env, cwd=REPO)
             for i in range(args.procs)]
    deadline = time.time() + args.timeout
    rc = 0
    for i, p in enumerate(procs):
        try:
            r = p.wait(timeout=max(1.0, deadline - time.time()))
        except subprocess.TimeoutExpired:
            r = -9
            print(f"launcher: worker {i} TIMED OUT after {args.timeout}s", flush=True)
        if r != 0:  # one worker down: the others would wait on it
            for q in procs:
                if q.poll() is None:
                    q.kill()
                    q.wait()
        rc = rc or r
    return {"demo": "multiprocess", "processes": args.procs, "local_devices": args.local_devices,
            "global_devices": args.procs * args.local_devices, "workload": args.workload,
            "mgcg": bool(args.mgcg), "device": args.device, "backend": args.backend,
            "verdict": "OK" if rc == 0 else "MISMATCH"}


def parse_args(argv=None) -> argparse.Namespace:
    """The command line, with the backend resolved; ``--device cuda``
    without a CUDA device raises."""
    p = argparse.ArgumentParser()
    p.add_argument("--worker", action="store_true", help="internal: run as a worker process")
    p.add_argument("--coordinator", default=None)
    p.add_argument("--process-id", type=int, default=0)
    p.add_argument("--procs", type=int, default=2)
    p.add_argument("--local-devices", type=int, default=4)
    p.add_argument("--workload", default="viennacl_large")
    p.add_argument("--mgcg", action="store_true", help="also run the rung-5 probed-MGCG path")
    p.add_argument("--grid", type=int, default=31, help="cubic grid extent for --mgcg")
    p.add_argument("--timeout", type=float, default=900.0)
    p.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    p.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                   help="default: nccl for --device cuda, gloo for --device cpu")
    p.add_argument("--reps", type=int, default=1, help="MGCG solves (the last one warm)")
    p.add_argument("--routes", action="store_true",
                   help="also the other routes held across processes")
    p.add_argument("--out", default=None, help="directory for each worker's rank<r>.pt")
    p.add_argument("--threads", type=int, default=0,
                   help="torch's intra-op threads and the BLAS and OpenMP threads in each "
                   "worker (0: the defaults)")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available")
    if args.backend is None:
        args.backend = "nccl" if args.device == "cuda" else "gloo"
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.worker:
        return worker(args)
    verdict = launch(args)
    print(json.dumps(verdict), flush=True)
    return 0 if verdict["verdict"] == "OK" else 1


if __name__ == "__main__":
    sys.exit(main())
