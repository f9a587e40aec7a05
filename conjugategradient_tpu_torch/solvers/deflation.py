"""Deflated / recycled CG: spectral deflation for sequences of solves.

The port of ``conjugategradient_tpu/solvers/deflation.py``.  The setting is
a sequence of solves with one matrix and a new right-hand side each (the
reference author's SPH pressure projection, its ``Initialize()`` once /
``Solve()`` many times split).  Plain CG pays for the lowest eigenmodes on
every solve; deflation finds them once (an m-step Lanczos probe on the
device) and removes them from every later Krylov iteration, so the
effective condition number drops from lambda_max/lambda_1 to
lambda_max/lambda_{k+1}.

Algorithm: def-CG (Saad, Yeung, Erhel, Guyomarc'h, SIAM J. Sci. Comput.
21(5), 2000) in the DEF form: a Galerkin initial guess makes W^T r0 = 0,
``cg_solve``'s ``project`` hook keeps every search direction A-orthogonal
to W, its ``project_r`` hook re-projects the residual every iteration
(without it fp32 def-CG diverges on an outlier spectrum, measured in the
JAX package), and a final Galerkin correction restores the deflated
solution components.  Per iteration that is a few ``(n, k)`` contractions
and a k x k Cholesky solve beside the product, all with TF32 off
(``ops.precision.no_tf32``): TF32, like the TPU's bf16 operand truncation,
cannot resolve the 1e-6-scale deflated components.

It applies where the low modes are isolated outliers (weakly coupled
unknowns, density contrast: ``core.generators.outlier_system``); clustered
low modes (the Poisson ladder) are multigrid's job.

Differences from the JAX package:

- ``make_deflation`` computes AW = A W with the fp64 product (the H100 has
  native fp64; kernel #4's fp64 instantiation for a DIA matrix) where the
  JAX package runs its two-fp32 dd SpMV; AW is that result rounded to the
  working dtype and E is formed from the fp64 value.
- The Lanczos start vector is drawn from a seeded host ``torch.Generator``
  (the JAX package's ``jax.random`` stream cannot be reproduced); pass
  ``v0`` to start from a given vector instead.
- ``Deflation.map_basis`` exists only for the JAX package's column-major
  Pallas layout, which the port does not have, and is left out.
- A sharded deflation (``parallel.sharded_cg.shard_deflation``) holds W and
  AW as ``parallel.mesh.Shards`` of row blocks and the k x k factor and
  scale on every shard's device; ``with_axis`` then makes the (k,) Galerkin
  contraction a ``psum`` over the mesh, and the coarse solve runs on every
  shard, as under the JAX package's ``shard_map``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import default_device, is_host, torch_dtype
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _contract(U: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``U^T v`` with TF32 off."""
    with no_tf32():
        return U.T @ v.reshape(-1)


def _coarse(chol_E: torch.Tensor, scale: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``E^-1 c`` through the equilibrated Cholesky factor."""
    y = torch.cholesky_solve((scale * c)[:, None], chol_E, upper=False)
    return scale * y[:, 0]


def _lift(U: torch.Tensor, c: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``U c`` in ``like``'s shape, TF32 off."""
    with no_tf32():
        return (U @ c).reshape(like.shape)


@dataclasses.dataclass(frozen=True)
class Deflation:
    """Deflation space: ``W`` (n, k) Ritz basis, ``AW = A @ W``, and the
    Galerkin matrix ``E = W^T A W`` in equilibrated form: ``scale`` =
    diag(E)^(-1/2) and ``chol_E`` the lower Cholesky factor of
    ``scale E scale``; all device tensors of one dtype.

    The equilibration is load-bearing in fp32: E's eigenvalues are the Ritz
    values, so a 1e-6 outlier against an O(1) bulk gives kappa(E) ~ 1e6 and
    a raw fp32 Cholesky solve loses most digits.  W is near A-orthogonal,
    so the scaled E is near the identity and its small solve is accurate.
    ``setup_s`` holds ``make_deflation``'s host-clock seconds by phase."""

    W: torch.Tensor
    AW: torch.Tensor
    chol_E: torch.Tensor
    scale: torch.Tensor
    psum_axis: Optional[str] = None
    setup_s: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def k(self) -> int:
        return self.W.shape[1]

    def with_axis(self, axis: Optional[str]) -> "Deflation":
        """Shard-local view: with ``psum_axis`` set the (k,) Galerkin
        contraction is psum'd over the mesh, so every hook works on
        row-sharded vectors of a deflation whose W and AW are
        ``parallel.mesh.Shards`` (``parallel.sharded_cg.shard_deflation``);
        the k x k solve runs on every shard."""
        if axis is not None:
            from conjugategradient_tpu_torch.parallel.mesh import Shards

            if not isinstance(self.W, Shards):
                raise TypeError("with_axis needs a sharded deflation "
                                "(parallel.sharded_cg.shard_deflation)")
        return dataclasses.replace(self, psum_axis=axis)

    def to(self, device) -> "Deflation":
        """The same deflation with its tensors on ``device``."""
        return dataclasses.replace(self, W=self.W.to(device), AW=self.AW.to(device),
                                   chol_E=self.chol_E.to(device), scale=self.scale.to(device))

    # -- the three pieces def-CG needs; vectors may be grid-shaped --------

    def _coeffs(self, U, v):
        """``E^-1 U^T v`` through the equilibrated factor (psum'd over the
        mesh when sharded)."""
        if self.psum_axis is None:
            return _coarse(self.chol_E, self.scale, _contract(U, v))
        from conjugategradient_tpu_torch.parallel.mesh import Shards, psum

        return Shards.map(_coarse, self.chol_E, self.scale, psum(Shards.map(_contract, U, v)))

    def _span(self, U, c, like):
        if self.psum_axis is None:
            return _lift(U, c, like)
        from conjugategradient_tpu_torch.parallel.mesh import Shards

        return Shards.map(_lift, U, c, like)

    def galerkin_correct(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """x + W E^-1 W^T r: the coarse solve that zeroes W^T r."""
        return x + self._span(self.W, self._coeffs(self.W, r), x)

    def project_direction(self, z: torch.Tensor) -> torch.Tensor:
        """z - W E^-1 (AW)^T z: keeps directions A-orthogonal to span{W}."""
        return z - self._span(self.W, self._coeffs(self.AW, z), z)

    def project_residual(self, r: torch.Tensor) -> torch.Tensor:
        """r - AW E^-1 W^T r: zeroes W^T r (W^T AW = E).  Applied every
        iteration through ``cg_solve``'s ``project_r``; the components it
        removes are restored by the final Galerkin correction."""
        return r - self._span(self.AW, self._coeffs(self.W, r), r)


def lanczos_basis(op: Callable, n: int, m: int, dtype=torch.float32, seed: int = 0,
                  device=None, v0=None):
    """m-step Lanczos with full reorthogonalisation, on ``device``.

    Returns ``(V, alphas, betas)``: ``V`` the (m, n) orthonormal Krylov
    basis, the scalars the tridiagonal Rayleigh quotient (device tensors;
    nothing is read to the host inside the loop).  The start vector is a
    standard normal draw of a host ``torch.Generator`` seeded with
    ``seed``, or ``v0`` (a host array or tensor, e.g. the JAX package's
    ``jax.random.normal(PRNGKey(seed), (n,))``), normalised.  The
    reorthogonalisation is two (m, n) products per step with TF32 off.
    """
    dt = torch_dtype(dtype)
    device = default_device(device)
    if v0 is None:
        gen = torch.Generator().manual_seed(seed)
        v0 = torch.randn(n, generator=gen, dtype=torch.float64)
    v0 = (v0 if torch.is_tensor(v0) else torch.from_numpy(np.array(v0))).to(device, dt)
    V = torch.zeros((m, n), dtype=dt, device=device)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.empty(m, dtype=dt, device=device)
    betas = torch.empty(m, dtype=dt, device=device)
    beta_prev = torch.zeros((), dtype=dt, device=device)
    v_prev = torch.zeros(n, dtype=dt, device=device)
    for j in range(m):
        q = V[j].clone()
        w = op(q)
        alpha = torch.dot(q, w)
        w = w - alpha * q - beta_prev * v_prev
        # full reorthogonalisation against the rows filled so far (rows
        # past j are zero, so the contraction is the full product)
        with no_tf32():
            w = w - V.T @ (V @ w)
        beta = torch.linalg.vector_norm(w)
        if j + 1 < m:
            V[j + 1] = torch.where(beta > 0, w / torch.where(beta > 0, beta, 1.0), 0.0)
        alphas[j], betas[j] = alpha, beta
        beta_prev, v_prev = beta, q
    return V, alphas, betas


def make_deflation(
    A,
    k: int = 8,
    m: Optional[int] = None,
    dtype=np.float32,
    seed: int = 0,
    use_pallas: bool = False,
    device=None,
) -> Deflation:
    """A k-dimensional deflation space for ``A`` (any container, host or
    device, or a callable) from an m-step Lanczos probe (default
    ``m = max(4k, 32)``) on ``device`` (``None``: the card when there is
    one), in ``dtype``.

    Setup: m products (Lanczos), one (m, m) host eigendecomposition, one
    (n, m) x (m, k) product, k fp64 products (AW), the k x k host
    equilibration and Cholesky; ``setup_s`` splits the seconds by phase
    (``lanczos``, ``eigh``, ``aw``, ``equilibration``).  Raises
    ``ValueError`` when the Galerkin matrix is not positive definite (A
    not SPD).  ``use_pallas`` is kept for parity and changes nothing.
    """
    m = m or max(4 * k, 32)
    device = default_device(device)
    dt = torch_dtype(dtype)
    setup_s = {}
    t0 = time.perf_counter()
    A_dev = A.device_put(dt, device) if hasattr(A, "device_put") else A
    n = A_dev.n
    V, alphas, betas = lanczos_basis(as_operator(A_dev), n, m, dt, seed, device)
    a = alphas.double().cpu().numpy()
    b_ = betas.double().cpu().numpy()[:-1]
    t1 = time.perf_counter()
    setup_s["lanczos"] = t1 - t0

    T = np.diag(a) + np.diag(b_, 1) + np.diag(b_, -1)
    _, S = np.linalg.eigh(T)
    Sk = torch.from_numpy(S[:, :k]).to(device, dt)  # the k smallest Ritz pairs
    with no_tf32():
        W = V.T @ Sk  # (n, k)
    t2 = time.perf_counter()
    setup_s["eigh"] = t2 - t1

    defl = deflation_from_basis(A, W, device=device)
    return dataclasses.replace(defl, setup_s={**setup_s, **defl.setup_s})


def galerkin_products(A, W: torch.Tensor, device=None):
    """``(AW64, E)``: ``A W`` as an fp64 device tensor and ``E = W^T A W``
    as a host fp64 array, for a basis ``W`` (n, k) on ``device``.

    AW to working accuracy: for an outlier mode (lambda ~ 1e-6 against an
    O(1) bulk) the fp32 product A w is pure cancellation (about 6% error
    measured in the JAX package), and def-CG needs W, AW and E consistent
    to the working precision or the W^T r = 0 invariant collapses.  So a
    container runs W's columns through its fp64 product (kernel #4's fp64
    instantiation for a DIA matrix on the card); a callable or a const
    stencil runs at W's dtype."""
    device = default_device(device)
    W64 = W.to(device, torch.float64)
    if hasattr(A, "device_put"):
        op64 = as_operator(A.device_put(torch.float64, device))
    else:
        op = as_operator(A)
        op64 = lambda v: op(v.to(W.dtype)).double()
    AW64 = torch.stack([op64(W64[:, j].contiguous()) for j in range(W.shape[1])], dim=1)
    return AW64, (W64.T @ AW64).cpu().numpy()


def deflation_from_basis(A, W: torch.Tensor, device=None) -> Deflation:
    """The ``Deflation`` of a basis ``W`` (n, k) in its dtype: AW the
    rounding of the fp64 ``A W`` (``galerkin_products``), E from the fp64
    value, equilibrated and factored on the host in fp64.  ``setup_s``
    holds the ``aw`` and ``equilibration`` seconds."""
    device = default_device(device)
    t0 = time.perf_counter()
    AW64, E = galerkin_products(A, W, device)
    t1 = time.perf_counter()
    # E is SPD in exact arithmetic; symmetrise the rounding skew only, with
    # no jitter: a perturbed E breaks the W^T r = 0 invariant the
    # recurrence rests on (measured in the JAX package)
    E = 0.5 * (E + E.T)
    dE = np.diag(E)
    msg = ("deflation Galerkin matrix is not positive definite — the Lanczos probe "
           "degenerated (is A symmetric positive definite?)")
    if not (np.isfinite(dE).all() and (dE > 0).all()):
        raise ValueError(msg)
    scale = 1.0 / np.sqrt(dE)
    Es = scale[:, None] * E * scale[None, :]
    try:
        L = np.linalg.cholesky(Es)
    except np.linalg.LinAlgError:
        raise ValueError(msg) from None
    place = lambda a: torch.from_numpy(a).to(device, W.dtype)
    setup_s = {"aw": t1 - t0, "equilibration": time.perf_counter() - t1}
    return Deflation(W.to(device), AW64.to(W.dtype), place(L), place(scale), setup_s=setup_s)


def deflated_cg_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    deflation: Deflation = None,
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
) -> CGResult:
    """Solve A x = b by def-CG on ``b``'s device: the Galerkin initial
    correction, ``cg_solve`` with ``project=deflation.project_direction``
    and ``project_r=deflation.project_residual``, then the final Galerkin
    correction.  The deflation's tensors must live on ``b``'s device in its
    dtype.  On a CUDA ``b`` a DIA ``A`` takes kernel #4 for every product:
    the iterations plus three."""
    if deflation is None:
        raise ValueError("deflated_cg_solve requires deflation=make_deflation(A)")
    if is_host(A):
        A = A.device_put(device=b.device)
    op = as_operator(A, use_pallas=use_pallas)
    x_init = torch.zeros_like(b) if x0 is None else x0.to(b.dtype)
    x_init = deflation.galerkin_correct(x_init, b - op(x_init))
    res = cg_solve(A, b, x_init, policy=policy, M=M, precise_dot=precise_dot,
                   use_pallas=use_pallas, project=deflation.project_direction,
                   project_r=deflation.project_residual)
    # project_r removed the span{W} residual components from the
    # recurrence; one true residual and a coarse solve put the matching
    # solution components back
    x = deflation.galerkin_correct(res.x, b - op(res.x))
    return dataclasses.replace(res, x=x)
