"""The port's multi-process mesh on the CPU: two OS processes over Gloo.

The twin of ``tests/test_multiprocess.py``.  One module fixture runs the
port's launcher (``conjugategradient_tpu_torch/scripts/multiprocess_demo.py``,
``launch``, here, so that its workers are the only new processes)
once: two processes join one ``torch.distributed`` group, each contributes
two CPU shards to a global 4-shard mesh (``multihost.global_mesh``),
assembles its own row blocks and runs the sharded CG (``ladder_dense_1k``,
fp64), rung 5's probed MGCG (Poisson 31³, fp32) and the other routes held
across processes, and saves its owned parts.  The tests then hold every
worker to

- the launcher's verdict and each worker's own-shard check against the
  fp64 oracle;
- ``psum``, ``pmax``, both ``ppermute`` shifts and the gathers across the
  process boundary, on the 1-D mesh and on a (2, 2) mesh of 2 processes x
  2 shards: their exact values;
- a one-process 4-shard mesh running the same functions in this process:
  the same iteration counts and owned x blocks bit for bit (``psum`` adds
  every shard's partial in global shard order on each process, so the
  sums are the one-process sums);
- the padded plane of rung 5's x exactly 0;
- the JAX package's jitted fp64 ``cg_solve`` on the same system: the same
  count, x within X_REL;
- stand-in workers that fail or hang: a MISMATCH verdict, the rest
  killed.

Torch and numpy's BLAS (the host-built hierarchies' dense coarse inverse)
run one thread in the workers (``--threads 1``) and here, as torch does in
every emulation file: the host setup rounds alike on both sides, and the
worker processes do not crowd the cores; the coordinator's port comes
from binding port 0.
"""

import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from conjugategradient_tpu.models import get as j_get
from conjugategradient_tpu.solvers.cg import cg_solve as j_cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.parallel import make_mesh
from conjugategradient_tpu_torch.scripts import multiprocess_demo as demo

WORKLOAD = "ladder_dense_1k"
GRID = 31
#: the launcher's deadline, seconds: its workers are killed past it
LAUNCH_TIMEOUT = 100
#: the same Krylov sequence in fp64 against the JAX package: x within this
#: fraction of max |x|
X_REL = 1e-10
ROUTES = ["cg cg1", "cg pipelined", "cg cacg", "cg all-gather", "rung5 cg", "shard_mgcg",
          "rung5 mg_bicgstab"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with threadpoolctl.threadpool_limits(limits=1):
            yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def launched(tmp_path_factory, _one_thread):
    """The launcher's verdict record and each worker's saved record; the
    launcher runs here, so that its workers are the only processes it
    starts, and kills them at its deadline."""
    out = tmp_path_factory.mktemp("multiprocess")
    args = demo.parse_args(["--procs", "2", "--local-devices", "2", "--workload", WORKLOAD,
                            "--mgcg", "--grid", str(GRID), "--routes", "--out", str(out),
                            "--threads", "1", "--timeout", str(LAUNCH_TIMEOUT)])
    verdict = demo.launch(args)
    recs = []
    for r in range(2):
        path = out / f"rank{r}.pt"
        recs.append(torch.load(path, weights_only=False) if path.exists() else None)
    return verdict, recs


@pytest.fixture(scope="module")
def one_process(_one_thread):
    """The same functions on a one-process 4-shard mesh, here."""
    m = make_mesh(4, devices=["cpu"] * 4)
    return dict(cg=demo.run_cg(m, WORKLOAD), mgcg=demo.run_mgcg(m, GRID),
                routes=demo.run_routes(m), collectives=demo.run_collectives(m))


def _rec(launched, r):
    verdict, recs = launched
    assert recs[r] is not None, verdict
    return recs[r]


def _owned(launched, key, route=None):
    """Both workers' owned parts, in global shard order."""
    if route is None:
        return [p for r in range(2) for p in _rec(launched, r)[key]["x"]]
    return [p for r in range(2) for p in _rec(launched, r)[key][route][1]]


def _same(a, b) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_verdict(launched):
    assert launched[0] == {"demo": "multiprocess", "processes": 2, "local_devices": 2,
                           "global_devices": 4, "workload": WORKLOAD, "mgcg": True,
                           "device": "cpu", "backend": "gloo", "verdict": "OK"}


@pytest.mark.parametrize("rank", [0, 1])
def test_worker_validates_its_own_shards(launched, rank):
    rec = _rec(launched, rank)
    assert rec["world"] == 2 and rec["owned"] == [2 * rank, 2 * rank + 1]
    assert rec["backend"] == "gloo" and rec["ok"]
    cg = rec["cg"]
    assert cg["converged"] and cg["ok"] and cg["worst_rel_err"] < demo.SHARD_TOL
    assert rec["mgcg"]["converged"] and rec["mgcg"]["ok"]


def _expected(name):
    """The exact value of each collective on shards holding arange(3) +
    10 i: (1-D) shard i at position i of 4; (2, 2) shard i at (i // 2, i % 2)."""
    v = [torch.arange(3, dtype=torch.float64) + 10.0 * i for i in range(4)]
    if name in ("psum", "2d psum"):
        return sum(v[1:], v[0])
    if name == "pmax":
        return v[3]
    if name in ("all_gather", "gather"):
        return torch.cat(v)
    if name == "2d gather":
        return torch.stack([torch.cat(v[:2]), torch.cat(v[2:])])
    parts = name.split()
    s = int(parts[-1])
    if parts[0] == "ppermute":
        return [v[(i - s) % 4] for i in range(4)]
    ax = 0 if parts[2] == "x" else 1

    def src(i):
        c = list(divmod(i, 2))
        c[ax] = (c[ax] - s) % 2
        return c[0] * 2 + c[1]

    return [v[src(i)] for i in range(4)]


COLLECTIVES = ["psum", "pmax", "ppermute 1", "ppermute -1", "all_gather", "gather", "2d psum",
               "2d ppermute x 1", "2d ppermute x -1", "2d ppermute y 1", "2d ppermute y -1",
               "2d gather"]


@pytest.mark.parametrize("name", COLLECTIVES)
def test_collective_across_processes(launched, one_process, name):
    want = _expected(name)
    ref = one_process["collectives"][name]
    got = [_rec(launched, r)["collectives"][name] for r in range(2)]
    if isinstance(want, list):  # a shifted Shards: each worker its two parts
        assert _same(got[0] + got[1], want) and _same(ref, want)
    else:  # replicated: every worker the whole value
        assert all(torch.equal(g, want) for g in got) and torch.equal(ref, want)


@pytest.mark.parametrize("solve", ["cg", "mgcg"])
def test_counts_and_owned_x_bit_equal_one_process(launched, one_process, solve):
    ref = one_process[solve]
    for r in range(2):
        assert _rec(launched, r)[solve]["iterations"] == ref["iterations"]
    assert _same(_owned(launched, solve), ref["x"])


@pytest.mark.parametrize("route", ROUTES)
def test_route_bit_equal_one_process(launched, one_process, route):
    its, x = one_process["routes"][route]
    for r in range(2):
        assert _rec(launched, r)["routes"][route][0] == its
    assert _same(_owned(launched, "routes", route), x)


@pytest.mark.parametrize("solve", ["mgcg", "rung5 cg"])
def test_padded_plane_exactly_zero(launched, solve):
    if solve == "mgcg":
        rec = _rec(launched, 1)["mgcg"]
        last, real0 = rec["x"][-1], rec["real0"]
        g0 = rec["padded"][0]
    else:
        last = _rec(launched, 1)["routes"][solve][1][-1]
        real0, g0 = 15, 16
    n0 = g0 // 4
    pad = last[real0 - 3 * n0:]
    assert pad.numel() > 0 and bool((pad == 0).all())


def test_cg_count_and_x_match_jax(launched):
    s = j_get(WORKLOAD).build(dtype=np.float64)
    pol = JPolicy(tol=demo.CG_POLICY.tol, norm=demo.CG_POLICY.norm,
                  max_iteration=demo.CG_POLICY.max_iteration)
    rj = jax.jit(lambda A, b, x0: j_cg_solve(A, b, x0, policy=pol))(
        s.A, jnp.asarray(s.b), jnp.asarray(s.x0))
    xj = np.asarray(rj.x)
    cg = _rec(launched, 0)["cg"]
    assert bool(rj.converged) and cg["iterations"] == int(rj.iterations)
    x = torch.cat(_owned(launched, "cg")).numpy()[:cg["n"]]
    assert np.abs(x - xj).max() / np.abs(xj).max() < X_REL


#: stand-in workers: (worker 0's code, worker 1's code, the launcher's
#: --timeout)
FAILING = {"a worker exits 3": ("pass", "raise SystemExit(3)", 60),
           "a worker outlives the deadline": ("pass", "import time; time.sleep(60)", 1),
           "the others are killed": ("raise SystemExit(3)", "import time; time.sleep(60)", 60)}


@pytest.mark.parametrize("case", sorted(FAILING))
def test_launcher_fails_when_a_worker_fails(monkeypatch, case):
    """A worker that fails or outlives the deadline fails the run (the
    command line exits 1 on the MISMATCH verdict), and the launcher kills
    the workers still running instead of waiting on them."""
    first, second, timeout = FAILING[case]
    monkeypatch.setattr(demo, "worker_command",
                        lambda args, coordinator, i: [sys.executable, "-c", (first, second)[i]])
    t0 = time.monotonic()
    verdict = demo.launch(demo.parse_args(["--procs", "2", "--timeout", str(timeout)]))
    assert verdict["verdict"] == "MISMATCH" and time.monotonic() - t0 < 30


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a CUDA device")
def test_device_cuda_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo.main(["--device", "cuda"])


class _RankOfTwo:
    """What a ``Mesh`` reads of a communicator: rank 0 of a world of 2."""

    world, rank, backend = 2, 0, "gloo"


def _refused():
    from conjugategradient_tpu_torch.core import generators
    from conjugategradient_tpu_torch.parallel import gspmd, shard_multi, shard_nonsym
    from conjugategradient_tpu_torch.parallel.sharded_general import make_sharded_cg_general
    from conjugategradient_tpu_torch.solvers.arnoldi import arnoldi_eigs
    from conjugategradient_tpu_torch.solvers.lobpcg import gspmd_lobpcg

    s = generators.poisson_system((16, 16))
    B = np.ones((s.n, 2))
    return {
        "the GSPMD carriers": lambda m: gspmd.make_gspmd_mgcg(s, (16, 16), m),
        "shard_system": lambda m: gspmd.shard_system(s, m),
        "make_sharded_cg_general": lambda m: make_sharded_cg_general(s.A, m),
        "make_sharded_nonsym": lambda m: shard_nonsym.make_sharded_nonsym(s.A, m),
        "make_sharded_lsmr": lambda m: shard_nonsym.make_sharded_lsmr(s.A, m),
        "make_shard_multi_mgcg": lambda m: shard_multi.make_shard_multi_mgcg(s, B, (16, 16), m),
        "sharded_cg_multi_solve": lambda m: shard_multi.sharded_cg_multi_solve(s.A, B, mesh=m),
        "gspmd_lobpcg": lambda m: gspmd_lobpcg(s.A, 2, m),
        "arnoldi_eigs(basis_sharding=)": lambda m: arnoldi_eigs(s.A, 2, device="cpu",
                                                                basis_sharding=(m, "x")),
    }


@pytest.mark.parametrize("route", ["the GSPMD carriers", "shard_system", "make_sharded_cg_general",
                                   "make_sharded_nonsym", "make_sharded_lsmr",
                                   "make_shard_multi_mgcg", "sharded_cg_multi_solve",
                                   "gspmd_lobpcg", "arnoldi_eigs(basis_sharding=)"])
def test_route_not_held_across_processes_raises(route):
    """A route this port does not hold across processes refuses a mesh that
    spans them, naming the ROADMAP item it waits for, before it computes
    on any rows."""
    from conjugategradient_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(["cpu"] * 4, comm=_RankOfTwo())
    assert mesh.owned == range(2) and len(mesh.local_devices) == 2
    with pytest.raises(NotImplementedError, match=f"{re.escape(route)} runs on a one-process mesh; "
                       "across processes it waits for ROADMAP queue 1, item 6d"):
        _refused()[route](mesh)
