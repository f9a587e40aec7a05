"""LOBPCG: block preconditioned eigensolver for the extreme eigenpairs.

The port of ``conjugategradient_tpu/solvers/lobpcg.py`` (Knyazev, SIAM J.
Sci. Comput. 23, 2001): the k smallest (or largest) eigenpairs of a sparse
SPD operator from block products only, preconditioned by any (n, k)
block map, a multigrid V-cycle per column
(``solvers.multi.as_multi_preconditioner``) making it a multigrid
eigensolver.  What it computes is the JAX package's; its layout is the
card's:

- The search block ``S = [X, W, P]`` is held as ``(3k, n)`` rows, each
  column of the JAX package's ``(n, 3k)`` block one contiguous row: the
  layout kernel #5 (``ops.cuda_dia.spmm_dia_cuda``, 8 columns a launch)
  reads for a ``DiaMatrix`` and ``ops.stencil.spmm_columns`` cuts a
  stencil's columns from (``solvers.multi._as_multi_operator``).  ``X0``,
  ``P0``, ``M``'s argument and result and ``eigenvectors`` keep the public
  ``(n, k)`` convention; each is transposed once at the boundary.
- Every Gram, whitening, Rayleigh-Ritz and basis-update matmul runs inside
  ``ops.precision.no_tf32``: TF32 keeps about three decimal digits, the
  hazard the JAX package pins ``Precision.HIGHEST`` against (the TPU's
  default left LOBPCG at 20% eigenvalue error).
- ``S`` is always ``3k`` rows: ``P`` starts as a random block, so the first
  iteration is a 3k-subspace Rayleigh-Ritz.
- Orthonormalisation is SPECTRAL (``_spectral_orth``), carried exactly:
  unit columns first, ``G = S S^T`` (``S (B S)^T`` for the generalized
  problem) symmetrised, its eigh, directions with ``w <= delta * max(w)``
  hard-zeroed, the rest whitened by ``1/sqrt(w)``; ``B Q`` comes back
  without a second B pass.  A shifted Cholesky-QR is cheaper and wrong
  here: the JAX package measured fake 4e-6 eigenvalues under the true
  5.9e-4 minimum of the 1-D Laplacian from its near-dependent columns.
  The dropped directions are parked above ``trace(|H|) + 1`` so the Ritz
  selection never takes them.
- The two ``3k x 3k`` eigendecompositions run on the host in the solve's
  dtype (each matrix read, decomposed by LAPACK and put back): on the
  H100 at k = 8 cuSOLVER's ``torch.linalg.eigh`` was no faster in fp32
  and slower in fp64 (``PERF.md``), and it synchronises for its error
  check all the same.

The loop is a Python loop with three host reads an iteration: whether the
worst column's residual is still at or above ``tol``, and the two small
matrices.  One A pass of width 3k an iteration (and one B pass), two more
of width k at the start.

JAX draws ``X0`` from ``PRNGKey(seed)`` and ``P0`` from ``PRNGKey(seed +
1)``; those streams cannot be reproduced in torch, so the port draws both
from a ``torch.Generator`` on the solve's device seeded by ``seed`` and
``seed + 1`` and takes ``P0=`` (the JAX package's draw, carried across by
``convert.lobpcg_draws_from_reference``) to run the JAX package's iterates.
The card's stream is not the host's: a card run and a CPU run of one seed
start from different blocks (pass ``X0``/``P0`` to start both alike).  On
the host the draws cost more than the rest of the solve: two (n, k) fp64
draws took 0.56-0.62 s of a 0.80 s fp32 call at n = 1,046,529, k = 8 on
an H100 machine's host (``PERF.md``).
``gspmd_lobpcg`` is the mesh twin, on the single-controller mesh of
``parallel.mesh``: A's (and B's) DIA data row-sharded, the ``(k, n)``
blocks as ``Shards`` of ``(k, n / num)`` rows, the A and B passes kernel
#5 on each shard's extended DIA (``parallel.halo.HaloDia``), every Gram
product and row norm the ``psum`` of the shards' local ones (under
``no_tf32``), and the small eigendecompositions once, on the first
shard's host side, replicated: the one-device trajectory up to the order
of the partials.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import default_device, place, torch_dtype
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.solvers.multi import _as_multi_operator



@dataclasses.dataclass(frozen=True)
class LobpcgResult:
    """Eigensolve outcome; the tensors stay on the solve's device."""

    eigenvalues: torch.Tensor  # (k,) ascending
    eigenvectors: torch.Tensor  # (n, k), columns (B-)orthonormal
    iterations: int
    residuals: torch.Tensor  # (k,) ||A x - lam B x|| / (|lam| + 1)
    converged: bool


def _eigh(G: torch.Tensor):
    """``torch.linalg.eigh`` of a small symmetric matrix on the host in its
    dtype, the factors put back on its device."""
    if G.device.type == "cpu":
        return torch.linalg.eigh(G)
    w, E = torch.linalg.eigh(G.cpu())
    return w.to(G.device), E.to(G.device)


def _local_gram(S, T):
    return S @ T.T


def _local_rowdot(a, b):
    return torch.sum(a * b, dim=1)


def _spectral_orth(S, delta: float, BS, gram=_local_gram, rowdot=_local_rowdot):
    """Whitened rows Q (the span of ``S``'s rows) with the near-null
    directions hard-zeroed: ``(Q, BQ, good)``.

    The rows are normalised FIRST (a vanished residual or P row must read
    as a dependent direction, not a small eigenvalue of G: the JAX package
    observed late corruption of converged pairs otherwise).  ``BS`` switches
    to the B inner product: G = S (B S)^T, Q B-orthonormal, and BQ the same
    combination of B S rows, so no second B pass.  ``gram(S, T)`` is ``S
    T^T`` and ``rowdot(a, b)`` the row-wise dots (over a mesh: the psum of
    the shards' local ones)."""
    BS_ = S if BS is None else BS
    norms = torch.sqrt(rowdot(S, BS_))
    scale = torch.where(norms > 0, norms, torch.ones_like(norms))[:, None]
    S = S / scale
    BS_ = BS_ / scale
    G = gram(S, BS_)
    G = 0.5 * (G + G.T)
    w, E = _eigh(G)
    good = w > delta * torch.max(w)
    inv_sqrt = torch.where(good, 1.0 / torch.sqrt(torch.where(good, w, torch.ones_like(w))),
                           torch.zeros_like(w))
    Ct = (E * inv_sqrt[None, :]).T
    Q = Ct @ S
    BQ = Q if BS is None else Ct @ BS_
    return Q, BQ, good


def _draw(n: int, k: int, seed: int, device="cpu") -> torch.Tensor:
    """The (n, k) fp64 standard normal draw of a ``torch.Generator`` on
    ``device`` seeded by ``seed``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return torch.randn((n, k), generator=gen, dtype=torch.float64, device=device)


def lobpcg(
    A,
    k: int,
    X0=None,
    M: Optional[Callable] = None,
    tol: float = 1e-6,
    max_iterations: int = 200,
    seed: int = 0,
    dtype=torch.float32,
    largest: bool = False,
    B=None,
    device=None,
    P0=None,
) -> LobpcgResult:
    """k extreme eigenpairs of sparse SPD ``A`` (smallest by default).

    ``A``: any matrix container (DIA, stencil, CSR, ELL, ...) or an ``(n,
    j) -> (n, j)`` block callable (then ``X0`` is required).  ``M``: an
    optional preconditioner on an ``(n, k)`` residual block (approximately
    A^-1: ``solvers.multi.as_multi_preconditioner(hierarchy)`` for
    multigrid, ``lambda R: inv_diag[:, None] * R`` for Jacobi).
    ``largest=True`` selects the top of the spectrum.  ``B`` (SPD, the same
    forms as A) makes it the generalized problem ``A x = lambda B x``: the
    basis is kept B-orthonormal, one A pass and one B pass of width 3k an
    iteration, and the residual is ``A X - (B X) diag(lam)``.

    ``dtype`` (torch or numpy) is the solve's; ``device`` where it runs
    (``None``: the card when there is one).  ``X0`` and ``P0`` are the
    ``(n, k)`` start block and first search directions (default: draws of
    a ``torch.Generator`` on ``device`` seeded by ``seed`` and ``seed + 1``;
    the card's stream differs from the host's).
    """
    dt = torch_dtype(dtype)
    dev = default_device(device)
    if callable(A) and not hasattr(A, "shape") and X0 is None:
        raise ValueError("X0 is required when A is passed as an operator")
    # (k, n) -> (k, n) rows: kernel #5 for a DiaMatrix, spmm_columns for a
    # stencil, ops.spmm otherwise, an (n, j) callable transposed around
    block_op = lambda C: _as_multi_operator(
        C.device_put(dt, dev) if hasattr(C, "device_put") else C, dev)
    op = block_op(A)
    opB = None if B is None else block_op(B)
    if X0 is None:
        n = A.shape[0]
        X0 = _draw(n, k, seed, dev)
    X0 = place(X0, dt, dev)
    n, k = X0.shape
    P = place(_draw(n, k, seed + 1, dev) if P0 is None else P0, dt, dev)
    if tuple(P.shape) != (n, k):
        raise ValueError(f"P0 must be (n, k) = ({n}, {k}), got {tuple(P.shape)}")
    lam, X, it, res = _lobpcg_rows(op, opB, X0.T.contiguous(), P.T.contiguous(), k,
                                   None if M is None else (lambda R: M(R.T).T.contiguous()),
                                   tol, max_iterations, dt, largest)
    order = torch.argsort(lam)
    return LobpcgResult(
        eigenvalues=lam[order],
        eigenvectors=X[order].T,
        iterations=it,
        residuals=res[order],
        converged=bool(torch.max(res) < tol),
    )


def _lobpcg_rows(op, opB, X0r, P, k: int, M_rows, tol: float, max_iterations: int, dt,
                 largest: bool, gram=_local_gram, rowdot=_local_rowdot):
    """The LOBPCG loop on ``(k, n)`` row blocks (tensors, or ``Shards`` of
    row blocks with ``gram``/``rowdot`` the psum'd forms): ``(lam, X, it,
    res)``, unsorted."""
    # Gram eigenvalues of unit rows below ~eps^2 are cancellation noise;
    # sqrt(eps)-scaled thresholds bound the whitening's amplification
    delta = 5e-7 if dt == torch.float32 else 1e-12
    sign = -1.0 if largest else 1.0
    orth = lambda S, BS: _spectral_orth(S, delta, BS, gram, rowdot)

    with no_tf32():
        X, BX, _ = orth(X0r, None if opB is None else opB(X0r))
        AX = op(X)
        lam = rowdot(X, AX)
        R = AX - BX * lam[:, None]
        res = torch.sqrt(rowdot(R, R)) / (torch.abs(lam) + 1.0)
        it = 0
        while it < max_iterations and bool(torch.max(res) >= tol):
            W = R if M_rows is None else M_rows(R)
            S = torch.cat([X, W, P], dim=0)
            Q, BQ, good = orth(S, None if opB is None else opB(S))
            AQ = op(Q)  # the one A pass of the iteration, width 3k
            H = gram(Q, AQ)
            H = 0.5 * (H + H.T)
            # park the dropped directions above every true Ritz value
            big = torch.trace(torch.abs(H)) + 1.0
            mask2d = good[:, None] & good[None, :]
            Hs = torch.where(mask2d, sign * H, torch.zeros_like(H))
            Hs = Hs + torch.diag(torch.where(good, torch.zeros_like(big), big))
            _theta, C = _eigh(Hs)
            C1t = C[:, :k].T.contiguous()  # ascending; the sign picks the end
            X_new = C1t @ Q
            AXn = C1t @ AQ  # A (Q C1) without a second pass
            BXn = X_new if opB is None else C1t @ BQ
            # the update's part outside span(X), in the B inner product
            # when generalized (X is B-orthonormal)
            P = X_new - gram(X_new, BX) @ X
            lam = rowdot(X_new, AXn)
            R = AXn - BXn * lam[:, None]
            res = torch.sqrt(rowdot(R, R)) / (torch.abs(lam) + 1.0)
            X, BX = X_new, BXn
            it += 1
    return lam, X, it, res


def gspmd_lobpcg(
    A,
    k: int,
    mesh,
    axis: str = "x",
    M: Optional[Callable] = None,
    dtype=torch.float32,
    seed: int = 0,
    B=None,
    X0=None,
    P0=None,
    **kw,
) -> LobpcgResult:
    """Mesh-distributed LOBPCG: ``lobpcg`` over the row blocks of a 1-D
    mesh (``axis`` its name).

    ``A`` (and ``B``) must be a ``DiaMatrix``: its data is row-sharded
    (``parallel.mesh.shard_rows``) and each A or B pass is kernel #5 on
    every shard's extended DIA (``parallel.halo.HaloDia``), one halo pair a
    pass.  The ``(k, n)`` blocks live as ``Shards`` of ``(k, n / num)``
    rows; every Gram product and row norm is the ``psum`` of the shards'
    local ones, and the ``3k x 3k`` eigendecompositions run once and are
    replicated.  ``M`` (optional) maps a ``Shards`` of ``(k, n / num)``
    residual rows to the same (a sharded V-cycle, say).  The start is the
    port's draw on the mesh's first device (``X0``/``P0``, ``(n, k)``,
    override it, as in ``lobpcg``), so the trajectory is ``lobpcg``'s on
    that device up to the order of the partials.  ``kw``: ``tol``,
    ``max_iterations``, ``largest``.  ``eigenvectors`` come back gathered
    on the first device.  A row count that does not divide the mesh raises
    ``ValueError`` (the JAX package's ``NamedSharding`` refuses it)."""
    from conjugategradient_tpu_torch.core.formats import DiaMatrix
    from conjugategradient_tpu_torch.parallel.halo import HaloDia
    from conjugategradient_tpu_torch.parallel.mesh import Shards, psum, shard_rows

    if not isinstance(A, DiaMatrix):
        raise TypeError("gspmd_lobpcg requires a DiaMatrix")
    if B is not None and not isinstance(B, DiaMatrix):
        raise TypeError("gspmd_lobpcg requires a DiaMatrix B")
    if mesh.ndim != 1 or axis != mesh.axis:
        raise ValueError(f"gspmd_lobpcg row-shards over a 1-D mesh's axis, not {axis!r} of "
                         f"{mesh}")
    mesh.one_process("gspmd_lobpcg")
    n, num = A.shape[0], mesh.size
    if n % num:
        raise ValueError(f"n={n} rows do not divide over {num} shards")
    dt = torch_dtype(dtype)
    dev = mesh.local_devices[0]

    def halo_op(C):
        n_local = n // num
        data = shard_rows(mesh, np.asarray(C.data), dt, dim=1)
        return HaloDia(data, tuple(C.offsets), C.bandwidth, C.bandwidth > n_local)

    op = halo_op(A)
    opB = None if B is None else halo_op(B)
    X0 = place(_draw(n, k, seed, dev) if X0 is None else X0, dt, dev)
    P = place(_draw(n, k, seed + 1, dev) if P0 is None else P0, dt, dev)
    if tuple(X0.shape) != (n, k) or tuple(P.shape) != (n, k):
        raise ValueError(f"X0 and P0 must be (n, k) = ({n}, {k})")
    rows = lambda Z: shard_rows(mesh, Z.T, dt, dim=1)

    def gram(S, T):
        return psum(Shards.map(_local_gram, S, T)).parts[0]

    def rowdot(a, b):
        return psum(Shards.map(_local_rowdot, a, b)).parts[0]

    tol = kw.pop("tol", 1e-6)
    lam, X, it, res = _lobpcg_rows(op, opB, rows(X0), rows(P), k, M, tol,
                                   kw.pop("max_iterations", 200), dt, kw.pop("largest", False),
                                   gram, rowdot)
    if kw:
        raise TypeError(f"gspmd_lobpcg got unexpected keyword arguments {sorted(kw)}")
    order = torch.argsort(lam)
    return LobpcgResult(
        eigenvalues=lam[order],
        eigenvectors=X.gather(1)[order].T,
        iterations=it,
        residuals=res[order],
        converged=bool(torch.max(res) < tol),
    )
