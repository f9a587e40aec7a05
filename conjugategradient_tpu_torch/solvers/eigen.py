"""Eigenvalue diagnostics and setup-time spectral bounds.

The port of ``conjugategradient_tpu/solvers/eigen.py``.  The host paths
(power iteration, Lanczos, Gershgorin, the condition number, the spectrum
of a CG run) are the same numpy code with the same ``default_rng`` start
vectors, so their results equal the JAX package's bit for bit.  The device
paths (``jacobi_eigenvalues``, ``power_iteration``) run on a tensor's
device, the card when the caller gives none; JAX's ``PRNGKey`` stream
cannot be reproduced, so ``power_iteration`` starts from a seeded
``torch.Generator`` and only its eigenvalue is the JAX package's.
The eigensolvers are ``solvers.lobpcg`` (block, symmetric) and
``solvers.arnoldi`` (Krylov-Schur, nonsymmetric, shift-invert), behind
``api.eigs``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import (
    DenseMatrix,
    DiaMatrix,
    default_device,
    dia_diagonal,
    dia_to_dense,
    host_f64,
    to_host,
    torch_dtype,
)


def jacobi_eigenvalues(A, tol: float = 1e-10, max_sweeps: int = 100, device=None) -> torch.Tensor:
    """All eigenvalues of a small symmetric matrix by cyclic Jacobi
    rotations, sorted ascending.

    ``A`` is a ``DiaMatrix``, a ``DenseMatrix``, a numpy array or a torch
    tensor (which stays on its device unless ``device`` is given; anything
    else goes to ``device``, ``None``: the card when there is one).  Each
    sweep applies the rotations of every (p, q), p < q, in row order, as
    the JAX package's scan does, until the off-diagonal Frobenius norm is
    at most ``tol`` or ``max_sweeps`` sweeps ran: one host read per sweep.
    A diagnostic for small matrices: each rotation is about a dozen eager
    operations.
    """
    if isinstance(A, DiaMatrix):
        A = dia_to_dense(to_host(A))
    if isinstance(A, DenseMatrix):
        A = A.data
    if torch.is_tensor(A):
        M = A.to(A.device if device is None else torch.device(device)).clone()
    else:
        M = torch.from_numpy(np.array(A)).to(default_device(device))
    n = M.shape[0]
    one = torch.ones((), dtype=M.dtype, device=M.device)
    zero = torch.zeros((), dtype=M.dtype, device=M.device)

    def off_norm(M):
        return torch.sqrt(torch.sum(M * M) - torch.sum(torch.diagonal(M) ** 2))

    sweeps = 0
    while sweeps < max_sweeps and bool(off_norm(M) > tol):
        for p in range(n - 1):
            for q in range(p + 1, n):
                apq, app, aqq = M[p, q], M[p, p], M[q, q]
                theta = (aqq - app) / (2.0 * torch.where(apq == 0, one, apq))
                t = torch.sign(theta) / (torch.abs(theta) + torch.sqrt(theta * theta + 1.0))
                t = torch.where(apq == 0, zero, t)
                c = 1.0 / torch.sqrt(t * t + 1.0)
                s = t * c
                rot_p = c * M[p, :] - s * M[q, :]
                rot_q = s * M[p, :] + c * M[q, :]
                M[p, :] = rot_p
                M[q, :] = rot_q
                col_p = c * M[:, p] - s * M[:, q]
                col_q = s * M[:, p] + c * M[:, q]
                M[:, p] = col_p
                M[:, q] = col_q
        sweeps += 1
    return torch.sort(torch.diagonal(M)).values


def power_iteration(
    op: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    iters: int = 30,
    seed: int = 0,
    dtype=torch.float32,
    device=None,
    generator=None,
) -> torch.Tensor:
    """Largest eigenvalue of a symmetric PSD operator, on ``device``
    (``None``: the card when there is one), as a 0-d tensor.  The start
    vector is normal from ``generator`` (default: a generator on ``device``
    seeded with ``seed``); ``iters`` steps of ``v <- A v / ||A v||``, the
    Rayleigh quotient of the last step."""
    dev = default_device(device)
    dt = torch_dtype(dtype)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(seed)
    v = torch.randn(n, generator=generator, device=dev, dtype=dt)
    v = v / torch.linalg.vector_norm(v)
    lam = torch.zeros((), dtype=dt, device=dev)
    for _ in range(iters):
        w = op(v)
        lam = torch.dot(w, v)
        nw = torch.linalg.vector_norm(w)
        v = w / torch.where(nw == 0, torch.ones_like(nw), nw)
    return lam


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


def lanczos_bounds(apply, n: int, k: int = 20, seed: int = 0) -> Tuple[float, float]:
    """(lambda_min, lambda_max) estimates of a symmetric operator via k-step
    Lanczos (host numpy, full reorthogonalisation: k is small)."""
    rng = np.random.default_rng(seed)
    k = min(k, n)
    Q = np.zeros((n, k + 1))
    alpha = np.zeros(k)
    beta = np.zeros(k + 1)
    q = rng.standard_normal(n)
    q /= np.linalg.norm(q)
    Q[:, 0] = q
    for j in range(k):
        w = apply(Q[:, j])
        alpha[j] = Q[:, j] @ w
        w -= alpha[j] * Q[:, j]
        if j > 0:
            w -= beta[j] * Q[:, j - 1]
        w -= Q[:, : j + 1] @ (Q[:, : j + 1].T @ w)  # reorthogonalise
        beta[j + 1] = np.linalg.norm(w)
        if beta[j + 1] < 1e-14:
            k = j + 1
            break
        Q[:, j + 1] = w / beta[j + 1]
    T = np.diag(alpha[:k]) + np.diag(beta[1:k], 1) + np.diag(beta[1:k], -1)
    ev = np.linalg.eigvalsh(T)
    return float(ev[0]), float(ev[-1])


def lanczos_ritz_bounds(op: Callable[[torch.Tensor], torch.Tensor], n: int, k: int,
                        seed: int = 0, device=None) -> Tuple[float, float]:
    """(lowest, highest) Ritz value of k steps of the plain three-term
    Lanczos recurrence of a symmetric operator, run in fp64 on ``device``
    (``None``: the card when there is one) from the ``default_rng(seed)``
    start vector of ``lanczos_bounds``.

    No reorthogonalisation, so it costs ``k`` products and O(k n) vector
    work, and its memory stays three vectors: the lost orthogonality only
    repeats converged Ritz values, and every Ritz value stays inside the
    spectrum's hull (to rounding), so a negative lowest one proves that the
    operator is indefinite.  The coefficients stay on the device until the
    end (one host read); the tridiagonal is cut at its first breakdown
    (``beta < 1e-14``)."""
    from scipy.linalg import eigvalsh_tridiagonal

    dev = default_device(device)
    k = min(int(k), n)
    q = torch.from_numpy(np.random.default_rng(seed).standard_normal(n)).to(dev)
    q = q / torch.linalg.vector_norm(q)
    q_prev = torch.zeros_like(q)
    alpha = torch.empty(k, dtype=torch.float64, device=dev)
    beta = torch.zeros(k + 1, dtype=torch.float64, device=dev)
    for j in range(k):
        w = op(q)
        alpha[j] = torch.dot(q, w)
        w = w - alpha[j] * q - beta[j] * q_prev
        beta[j + 1] = torch.linalg.vector_norm(w)
        q_prev, q = q, w / beta[j + 1]
    a, b = alpha.cpu().numpy(), beta.cpu().numpy()[1:]
    stop = np.flatnonzero(b < 1e-14)
    m = int(stop[0]) + 1 if stop.size else k
    ev = eigvalsh_tridiagonal(a[:m], b[: m - 1])
    return float(ev[0]), float(ev[-1])


def gershgorin_bounds(A: DiaMatrix) -> Tuple[float, float]:
    """Cheap inclusion bounds from the DIA data (host or device): for each
    row, [a_ii - R_i, a_ii + R_i] with R_i the off-diagonal absolute row
    sum."""
    A = to_host(A)
    data = np.asarray(A.data)
    if 0 in A.offsets:
        diag = data[A.offsets.index(0)]
    else:
        diag = np.zeros(A.n, dtype=data.dtype)
    radius = np.abs(data).sum(axis=0) - np.abs(diag)
    return float((diag - radius).min()), float((diag + radius).max())


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


def condition_number(A, k: int = 30) -> float:
    """kappa_2(A) estimate via Lanczos on a host container (the R
    prototype's commented-out ``kappa(A)`` probe, ``R/CG.R:27``)."""
    A = to_host(A)
    apply = lambda v: oracle.spmv(A, v) if not isinstance(A, DenseMatrix) else np.asarray(A.data) @ v
    lo, hi = lanczos_bounds(apply, A.n, k)
    if lo <= 0:
        return float("inf")
    return hi / lo


def spectrum_from_cg(alphas, betas, iterations: int):
    """Extremal eigenvalues and condition number of the (preconditioned)
    operator from a CG run's own scalars.

    CG is Lanczos on M^{-1}A in disguise: its step scalars assemble the
    Lanczos tridiagonal (Saad, *Iterative Methods*, §6.7.3)

        T[j, j]   = 1/alpha_j + beta_{j-1}/alpha_{j-1}   (beta_{-1} = 0)
        T[j, j+1] = sqrt(beta_j)/alpha_j

    whose Ritz values converge to the extremal spectrum of M^{-1}A.  Feed
    it the ``(alphas, betas)`` that ``cg_solve_traced(...,
    with_coefficients=True)`` records (host arrays or tensors on any
    device) and the result's ``iterations``.  Returns ``(lam_min,
    lam_max, kappa)``, interior estimates; host fp64 numpy.
    """
    m = int(iterations)
    if m < 1:
        raise ValueError("spectrum_from_cg needs at least one CG iteration")
    a = host_f64(alphas)[:m]
    b = host_f64(betas)[:m]
    if np.any(a == 0):
        # frozen/exact-convergence steps inside the window: trim at first 0
        m = int(np.argmax(a == 0))
        if m < 1:
            raise ValueError("no usable CG coefficients (alpha[0] == 0)")
        a, b = a[:m], b[:m]
    diag = 1.0 / a
    diag[1:] += b[:-1] / a[:-1]
    off = np.sqrt(np.maximum(b[:-1], 0.0)) / a[:-1]
    from scipy.linalg import eigh_tridiagonal

    w = eigh_tridiagonal(diag, off, eigvals_only=True)
    lam_min, lam_max = float(w[0]), float(w[-1])
    kappa = lam_max / lam_min if lam_min > 0 else float("inf")
    return lam_min, lam_max, kappa
