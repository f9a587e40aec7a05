"""Setup-time spectral bounds (host numpy).

The slice of ``conjugategradient_tpu/solvers/eigen.py`` that the multigrid
setup runs: the host power iteration and the Chebyshev smoothing interval of
a variable-coefficient level.  The same numpy code with the same
``default_rng(0)`` start vector, so the bounds equal the JAX package's
exactly.  Lanczos, LOBPCG, Arnoldi and the device power iteration are still
to port (ROADMAP queue 1: preconditioners, solver families).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix, dia_diagonal


def power_iteration_host(apply, n: int, iters: int = 30, seed: int = 0) -> float:
    """numpy power iteration for setup-time bounds (no device round trips)."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v /= np.linalg.norm(v)
    lam = 0.0
    for _ in range(iters):
        w = apply(v)
        lam = float(w @ v)
        nw = np.linalg.norm(w)
        if nw == 0:
            return 0.0
        v = w / nw
    return lam


def scaled_spectrum_bounds(
    A: DiaMatrix, iters: int = 30, lower_frac: float = 0.25
) -> Tuple[float, float]:
    """Smoothing-interval bounds on spec(D^{-1}A) for Chebyshev setup.

    Upper bound: host power iteration on D^{-1}A with a 10% safety margin.
    Lower bound: ``lower_frac * lam_max``, the classic multigrid smoothing
    interval [lam_max/4, lam_max]: the smoother owns the upper spectrum, the
    coarse-grid correction owns the rest.
    """
    inv_d = 1.0 / _dia_diag(A)
    lam_max = power_iteration_host(lambda v: inv_d * oracle.spmv(A, v), A.n, iters)
    lam_max *= 1.1
    return lower_frac * lam_max, lam_max


def _dia_diag(A: DiaMatrix) -> np.ndarray:
    d = dia_diagonal(A)
    if np.any(d == 0):
        raise ValueError("matrix has zero diagonal entries; cannot Jacobi-scale")
    return d
