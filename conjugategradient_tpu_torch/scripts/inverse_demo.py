"""Inverse problem: recover operator coefficients by differentiating
through the solver.

The port of ``examples/inverse_demo.py``: a banded SPD operator whose
diagonal carries an unknown per-row stiffness field theta; observe the
solution ``x_obs = A(theta_true)^-1 b`` (optionally noisy) and recover
theta from zero with Adam, each gradient one forward and one adjoint CG
solve (``solvers.diff.cg_solve_implicit``).

    python -m conjugategradient_tpu_torch.scripts.inverse_demo [--cpu] [--n N] [--steps S]

Prints the loss before and after, the relative coefficient error and
``OK`` or ``MISMATCH``; exits 0 or 1.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import default_device
from conjugategradient_tpu_torch.solvers.diff import cg_solve_implicit
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def recover(n: int = 192, band: int = 8, steps: int = 400, noise: float = 0.0, lr: float = 5e-2,
            device=None, dtype=torch.float64, log_every: int = 0) -> dict:
    """Run the recovery; returns ``loss0``, ``loss``, ``losses`` (every
    step's), ``coeff_err`` (relative) and ``wall_s``."""
    device = default_device(device)
    sys_ = generators.banded_sin_system(n, band)
    offs, shape = sys_.A.offsets, sys_.A.shape
    diag_k = offs.index(0)
    base = torch.from_numpy(np.asarray(sys_.A.data)).to(device, dtype)
    b = torch.from_numpy(sys_.b).to(device, dtype)
    pol = ConvergencePolicy(tol=1e-12, norm="rel_l2", max_iteration=4000)
    rng = np.random.default_rng(0)
    theta_true = torch.from_numpy(0.5 + 0.4 * rng.random(n)).to(device, dtype)
    onehot = torch.zeros((len(offs), 1), dtype=dtype, device=device)
    onehot[diag_k] = 1.0

    def forward(theta):
        return cg_solve_implicit(base + onehot * theta, b, offs, shape, pol)

    with torch.no_grad():
        x_obs = forward(theta_true)
        if noise > 0:
            x_obs = x_obs + noise * torch.from_numpy(rng.standard_normal(n)).to(device, dtype)

    theta = torch.zeros(n, dtype=dtype, device=device, requires_grad=True)
    opt = torch.optim.Adam([theta], lr=lr)
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        opt.zero_grad()
        loss = torch.mean((forward(theta) - x_obs) ** 2)
        loss.backward()
        opt.step()
        losses.append(loss.item())
        if log_every and step % log_every == 0:
            print(f"  step {step:4d}  loss {losses[-1]:.3e}")
    wall = time.perf_counter() - t0
    with torch.no_grad():
        final = float(torch.mean((forward(theta) - x_obs) ** 2))
        err = float(torch.linalg.vector_norm(theta - theta_true)
                    / torch.linalg.vector_norm(theta_true))
    return dict(loss0=losses[0] if losses else final, loss=final, losses=losses, coeff_err=err,
                wall_s=wall)


def meets_goal(out: dict, noise: float = 0.0) -> bool:
    """The demo's verdict: without noise the loss falls by 1e6 and theta
    lands within 5% of the truth; with noise the loss reaches about
    10 noise^2 (the floor of fitting noise)."""
    goal = 1e-6 * max(out["loss0"], 1e-30) if noise == 0 else 10.0 * noise ** 2
    return out["loss"] < goal and (out["coeff_err"] < 0.05 or noise > 0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=192)
    ap.add_argument("--band", type=int, default=8)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--noise", type=float, default=0.0)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    out = recover(args.n, args.band, args.steps, args.noise,
                  device="cpu" if args.cpu else None, log_every=100)
    l0, l1 = out["loss0"], out["loss"]
    print(f"loss {l0:.3e} -> {l1:.3e} in {args.steps} Adam steps ({out['wall_s']:.1f} s); "
          f"relative coefficient error {out['coeff_err']:.2e}")
    ok = meets_goal(out, args.noise)
    print("OK" if ok else "MISMATCH")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
