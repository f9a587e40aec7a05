"""Three witnesses of fp64 pipelined CG on the cuBlas flagship, on the CPU.

Run: ``python tests/pipelined_witness.py [--cap 300] [--shards 4]``
(about five minutes on 8 cores).  Not collected by pytest.

Pipelined CG (Ghysels-Vanroose) carries ``w = A r`` and ``z = A w`` as
recurrences of their own, so rounding can part them from the products they
stand for.  Whether the port's sharded pipelined loop stalls on the flagship
because of that drift or because of a fault of its own is settled by solving
the same padded system, from the same x0 and under the same policy, with

- the port: ``conjugategradient_tpu_torch.parallel.sharded_cg_solve
  (variant="pipelined")`` on ``--shards`` CPU shards;
- the JAX package: ``conjugategradient_tpu.parallel.sharded_cg_solve
  (variant="pipelined")`` on ``--shards`` virtual CPU devices;
- a textbook unpreconditioned pipelined CG written here in numpy on scipy's
  CSR product, run for the port's iteration count;

and printing, for each, the iterations, the convergence flag, the
recurrence's residual and the true fp64 ``||b - A x||_2``.  Textbook CG (the
JAX package's ``variant="cg"``) is the control.  The port's and the numpy
solves are run a second time with b one ulp larger: how far that moves
their true residual is how far rounding alone moves it.

The cases: the workload's policy (l2 1e-8, 200 minimum iterations) from the
workload's x0 and from x0 = 0, and ``rel_l2`` 1e-10 and 1e-12 from x0 = 0
(the second the policy the chip smoke holds pipelined CG to), each capped at
``--cap`` iterations.
"""

import argparse
import dataclasses
import os
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--cap", type=int, default=300, help="iteration cap of every case")
parser.add_argument("--shards", type=int, default=4, help="row blocks of every sharded solve")
args = parser.parse_args()

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={args.shards}")
os.environ["JAX_PLATFORMS"] = "cpu"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import scipy.sparse as sp  # noqa: E402

from conjugategradient_tpu.parallel.mesh import make_mesh as j_make_mesh  # noqa: E402
from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve as j_solve  # noqa: E402
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy  # noqa: E402
from conjugategradient_tpu_torch.core.partition import pad_system  # noqa: E402
from conjugategradient_tpu_torch.models.workloads import WORKLOADS  # noqa: E402
from conjugategradient_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_solve  # noqa: E402
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy  # noqa: E402

FLAGSHIP = "cublas_flagship"


def dia_to_scipy(A):
    """The padded DIA as a scipy CSR (data[d, i] is A[i, i + offsets[d]])."""
    n = A.n
    rows, cols, vals = [], [], []
    for d, off in enumerate(np.asarray(A.offsets)):
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
        vals.append(np.asarray(A.data)[d, i])
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                         shape=(n, n))


def textbook_pipelined(csr, b, x0, iterations):
    """Ghysels-Vanroose pipelined CG without a preconditioner (their
    Algorithm 4 with M = I) for a fixed number of iterations; x and
    sqrt(r.r) of the recurrence."""
    x = x0.copy()
    r = b - csr @ x
    w = csr @ r
    z = s = p = None
    gamma_old = alpha_old = None
    for i in range(iterations):
        gamma, delta = r @ r, w @ r
        n_ = csr @ w
        if i == 0:
            beta, alpha = 0.0, gamma / delta
            z, s, p = n_, w.copy(), r.copy()
        else:
            beta = gamma / gamma_old
            alpha = gamma / (delta - beta * gamma / alpha_old)
            z, s, p = n_ + beta * z, w + beta * s, r + beta * p
        x += alpha * p
        r -= alpha * s
        w -= alpha * z
        gamma_old, alpha_old = gamma, alpha
    return x, float(np.sqrt(r @ r))


def main():
    system, n = pad_system(WORKLOADS[FLAGSHIP].build(), args.shards)
    A, b, x0 = system.A, system.b, system.x0
    csr = dia_to_scipy(A)
    true_l2 = lambda x: float(np.linalg.norm(b - csr @ np.asarray(x, np.float64)))  # noqa: E731
    mesh = make_mesh(args.shards, devices=["cpu"] * args.shards)
    jmesh = j_make_mesh(args.shards)
    wl = dataclasses.asdict(WORKLOADS[FLAGSHIP].policy)
    cases = (("workload policy, workload x0", dict(wl, max_iteration=args.cap), x0),
             ("workload policy, x0 = 0", dict(wl, max_iteration=args.cap), 0 * x0),
             ("rel_l2 1e-10, x0 = 0", dict(tol=1e-10, norm="rel_l2", max_iteration=args.cap),
              0 * x0),
             ("rel_l2 1e-12, x0 = 0", dict(tol=1e-12, norm="rel_l2", max_iteration=args.cap),
              0 * x0))
    print(f"{FLAGSHIP}: n {n} padded to {A.n}, {A.ndiags} diagonals, {args.shards} shards, "
          f"cap {args.cap}; workload policy {WORKLOADS[FLAGSHIP].policy}")
    for name, pol, start in cases:
        t0 = time.perf_counter()
        r = sharded_cg_solve(A, b, start, ConvergencePolicy(**pol), mesh, variant="pipelined")
        port = (r.iterations, bool(r.converged), float(r.residual), true_l2(r.x.numpy()))
        b_up = np.nextafter(b, np.inf)
        ru_port = sharded_cg_solve(A, b_up, start, ConvergencePolicy(**pol), mesh,
                                   variant="pipelined")
        jr = j_solve(A, b, start, JPolicy(**pol), jmesh, variant="pipelined")
        jax_ = (int(jr.iterations), bool(jr.converged), float(jr.residual), true_l2(jr.x))
        xt, rt = textbook_pipelined(csr, b, np.asarray(start, np.float64), port[0])
        xu, ru = textbook_pipelined(csr, b_up, np.asarray(start, np.float64), port[0])
        jc = j_solve(A, b, start, JPolicy(**pol), jmesh, variant="cg")
        cg = (int(jc.iterations), bool(jc.converged), float(jc.residual), true_l2(jc.x))
        print(f"{name} ({time.perf_counter() - t0:.1f} s): (iterations, converged, recurrence "
              f"residual, true ||r||_2)")
        print(f"  port pipelined      {port}")
        print(f"  port, b + 1 ulp     ({ru_port.iterations}, {bool(ru_port.converged)}, "
              f"{float(ru_port.residual)!r}, "
              f"{float(np.linalg.norm(b_up - csr @ ru_port.x.numpy()))!r})")
        print(f"  JAX pipelined       {jax_}")
        print(f"  numpy pipelined     ({port[0]}, -, {rt!r}, {true_l2(xt)!r})")
        print(f"  numpy, b + 1 ulp    ({port[0]}, -, {ru!r}, "
              f"{float(np.linalg.norm(b_up - csr @ xu))!r})")
        print(f"  JAX cg (control)    {cg}")


if __name__ == "__main__":
    main()
