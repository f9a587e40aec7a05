"""Three witnesses of plain BiCGStab in fp32 on transport-dominated
convection-diffusion, on the CPU.

Run: ``python tests/bicgstab_fp32_witness.py [--grid 1024] [--cap 2000]``
(about a minute at 1024^2 on 8 cores).  Not collected by pytest.

The chip smoke's sharded nonsymmetric phase runs plain BiCGStab on the
1024^2 convection at eps 0.05 in fp64, because in fp32 it does not
converge.  Whether that is the port's fault or the method's is settled by
solving the same system, under rel_l2 1e-6 from x0 = 0, with

- the port: ``conjugategradient_tpu_torch.solvers.bicgstab.bicgstab_solve``
  on the CPU;
- the JAX package: ``conjugategradient_tpu.solvers.bicgstab.bicgstab_solve``
  on the CPU;
- a textbook unpreconditioned BiCGStab written here in numpy on scipy's CSR
  product, which also records ``|rho| / (||rhat|| ||r||)``, the cosine
  between the shadow and the residual that BiCGStab divides by;

each in fp32 and in fp64, and printing the iterations, the convergence
flag, the final residual, whether x is finite and (numpy) the smallest
cosine and the largest residual on the way.
"""

import argparse
import os
import sys
import time

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--grid", type=int, default=1024, help="the square grid's side")
parser.add_argument("--eps", type=float, default=0.05, help="the diffusion coefficient")
parser.add_argument("--cap", type=int, default=2000, help="iteration cap of every solve")
args = parser.parse_args()

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from conjugategradient_tpu.core import formats as jformats  # noqa: E402
from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve as j_bicgstab  # noqa: E402
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy  # noqa: E402
from conjugategradient_tpu_torch.core import generators  # noqa: E402
from conjugategradient_tpu_torch.core.io import to_scipy  # noqa: E402
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve  # noqa: E402
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy  # noqa: E402

TOL = 1e-6


def textbook(A, b, cap):
    """Unpreconditioned BiCGStab (van der Vorst), rhat = r0: (iterations,
    residual, smallest |rho| / (||rhat|| ||r||), largest residual)."""
    dt = b.dtype.type
    x = np.zeros_like(b)
    r = b.copy()
    rhat = r.copy()
    rho_prev = alpha = omega = dt(1)
    v = p = np.zeros_like(b)
    nb = np.linalg.norm(b)
    cos_min, res_max, res = np.inf, 0.0, 1.0
    with np.errstate(all="ignore"):
        for it in range(1, cap + 1):
            rho = rhat @ r
            cos_min = min(cos_min, abs(float(rho)) / float(np.linalg.norm(rhat) * np.linalg.norm(r)))
            p = r + (rho / rho_prev) * (alpha / omega) * (p - omega * v)
            v = A @ p
            alpha = rho / (rhat @ v)
            s = r - alpha * v
            t = A @ s
            omega = (t @ s) / (t @ t)
            x = x + alpha * p + omega * s
            r = s - omega * t
            rho_prev = rho
            res = float(np.linalg.norm(r) / nb)
            if not np.isfinite(res) or res < TOL:
                break
            res_max = max(res_max, res)
    return it, res, cos_min, res_max


def main():
    g = (args.grid, args.grid)
    s = generators.convection_diffusion_system(g, eps=args.eps)
    print(f"convection-diffusion {g} eps {args.eps}: n {s.n}, rel_l2 {TOL}, cap {args.cap}")
    csr = to_scipy(s.A).tocsr()
    for np_dt, t_dt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        name = np.dtype(np_dt).name
        t0 = time.perf_counter()
        r = bicgstab_solve(s.A.device_put(t_dt, "cpu"), torch.from_numpy(s.b.astype(np_dt)),
                           policy=ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=args.cap))
        print(f"port  {name}: {r.iterations} iterations, converged {r.converged}, residual "
              f"{float(r.residual):.3e}, x finite {bool(torch.isfinite(r.x).all())} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        t0 = time.perf_counter()
        jA = jformats.DiaMatrix(s.A.data, s.A.offsets, s.A.shape).device_put(dtype=jnp.dtype(np_dt))
        jr = j_bicgstab(jA, jnp.asarray(s.b, np_dt), None,
                        JPolicy(tol=TOL, norm="rel_l2", max_iteration=args.cap))
        print(f"jax   {name}: {int(jr.iterations)} iterations, converged {bool(jr.converged)}, "
              f"residual {float(jr.residual):.3e}, x finite "
              f"{bool(np.isfinite(np.asarray(jr.x)).all())} ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        t0 = time.perf_counter()
        it, res, cos_min, res_max = textbook(csr.astype(np_dt), s.b.astype(np_dt), args.cap)
        print(f"numpy {name}: {it} iterations, residual {res:.3e}, smallest |rho| / (||rhat|| "
              f"||r||) {cos_min:.3e}, largest residual on the way {res_max:.3e} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)


if __name__ == "__main__":
    main()
