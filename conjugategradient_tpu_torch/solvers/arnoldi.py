"""Krylov-Schur (thick-restart Arnoldi) eigensolver for nonsymmetric operators.

The port of ``conjugategradient_tpu/solvers/arnoldi.py``: Arnoldi with
Krylov-Schur thick restarting (Stewart, SIAM J. Matrix Anal. Appl. 23(3),
2001), the restarting behind ARPACK-style ``eigs`` expressed through the
ordered Schur form, so a restart is a plain basis contraction.  For
operators with complex spectra and interior nonsymmetric eigenvalues, where
the symmetric tools (Lanczos, LOBPCG) do not apply.

The split of labour is the JAX package's:

- DEVICE: the ``(m+1, n)`` basis expansion, a Python loop over steps ``j =
  p .. m-1`` with one operator application a step (kernel #4 for a
  ``DiaMatrix``) and CGS2 against the slice ``V[:j+1]`` (the JAX package's
  row mask), in full fp32 (``ops.precision.no_tf32``: TF32 is the TPU
  default-precision hazard the JAX package pins ``Precision.HIGHEST``
  against).  The lucky-breakdown guard stays on the card
  (``torch.where``), so a plain expansion reads nothing; ``S`` and ``beta``
  are read once a cycle.
- HOST: the ``(m, m)`` projected eigen and Schur work of a restart, numpy
  and scipy code copied from the JAX package (``default_rng(seed)`` for
  ``v0``, ``np.linalg.eig``, ``scipy.linalg.schur(sort=)``, the
  lucky-breakdown truncation and deflate-restart, the widening of the
  restart for Schur-sort ties and 2x2 blocks, the coupling row ``b^T``).
  With the same ``v0`` the fp64 CPU run follows the JAX package's up to
  reduction rounding.
- The restart contraction ``Q1^T V[:m]`` and the final ``Y^T V`` are gemms
  on the card in full fp32.

Shift-invert (``sigma=``): each matvec is one inner solve of ``(A - sigma
I) w = v`` by the port's IDR(4) (default), BiCGStab or GMRES(40), each
solve's ``converged`` AND-reduced into ``inner_converged`` and its
applications of ``A - sigma I`` summed into ``inner_matvecs``; the values
are mapped back ``lambda = sigma + 1/theta`` and the residuals recomputed
against the original operator as one block product of the 2k' real and
imaginary columns (kernel #5 for a ``DiaMatrix``; the JAX package's
``lax.map``).  In fp32 ``inner_tol`` defaults to 1e-3, not the JAX
package's 1e-6: the port's IDR accepts convergence only on a recomputed
residual ``b - A x``, whose fp32 floor grows with the condition of ``A -
sigma I`` (convection-diffusion eps 0.1, sigma 0, a V-cycle M, CPU runs:
1e-5 reached at 31^2, 1e-4 but not 3e-5 at 63^2, 1e-3 but not 1e-4 at
127^2).  Under its floor an inner solve runs to ``inner_max_iteration``
and can diverge, which raises ``FloatingPointError``.

The mesh twin (``gspmd_arnoldi_eigs``, ``arnoldi_eigs(basis_sharding=(mesh,
axis))``) holds the ``(m+1, n)`` basis as ``Shards`` of ``(m+1, n / num)``
row blocks of a 1-D mesh of ``parallel.mesh``: the expansion's product is
kernel #4 on each shard's extended DIA (``parallel.halo.HaloDia``), CGS2's
projections and the norms are ``psum``s of the shards' local ``V[:j+1] @
w`` and dots, the restart contraction and the final ``Y^T V`` stay local,
and ``v0`` is the same host draw, split.  Under ``sigma=`` the inner
IDR(4), BiCGStab or GMRES(40) are ``parallel.shard_nonsym``'s sharded
loops.  The host Schur work is the one-device code.

Left out: the JAX package's ``_EXPAND_CACHE`` / ``_APPLY_CACHE`` LRUs of
jitted expansions (PyTorch compiles nothing, so there is nothing to reuse).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import default_device, torch_dtype
from conjugategradient_tpu_torch.ops.blas import dot as _dot
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.ops.spmv import as_operator, prepare
from conjugategradient_tpu_torch.parallel.mesh import Shards
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
from conjugategradient_tpu_torch.solvers.cg import _safe_div
from conjugategradient_tpu_torch.solvers.gmres import gmres_solve
from conjugategradient_tpu_torch.solvers.idr import idr_solve
from conjugategradient_tpu_torch.solvers.multi import _as_multi_operator
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy



@dataclasses.dataclass(frozen=True)
class EigsResult:
    """k approximate eigenpairs of a (generally nonsymmetric) operator.

    ``values``/``vectors`` are complex numpy arrays (real inputs with real
    spectra come back with zero imaginary parts); ``vectors`` columns have
    unit 2-norm.  ``residuals[i]`` is ``||A x_i - lambda_i x_i||_2``: the
    free Arnoldi recurrence estimate for plain solves, and under
    shift-invert a directly recomputed true residual.  ``matvecs`` counts
    operator applications (inner SOLVES under shift-invert).

    SHORT RETURN: on lucky breakdown (an exact invariant subspace smaller
    than ``k``) the arrays may carry FEWER than ``k`` entries after the
    deflate-restart budget is exhausted; the pairs returned are then exact
    but ``converged`` is False.
    """

    values: np.ndarray  # (k,) complex128
    vectors: np.ndarray  # (n, k) complex128, unit columns
    residuals: np.ndarray  # (k,) float64
    matvecs: int
    restarts: int
    converged: bool
    inner_converged: bool = True  # shift-invert: every inner solve hit inner_tol
    inner_matvecs: int = 0  # shift-invert: applications of A - sigma I, all inner solves


def _order(which: str, theta: np.ndarray) -> np.ndarray:
    """Indices of ``theta`` sorted most-wanted first."""
    if which == "LM":
        key = -np.abs(theta)
    elif which == "SM":
        key = np.abs(theta)
    elif which == "LR":
        key = -theta.real
    elif which == "SR":
        key = theta.real
    elif which == "LI":
        key = -np.abs(theta.imag)
    else:
        raise ValueError(f"unknown which={which!r}; want LM|SM|LR|SR|LI")
    return np.argsort(key, kind="stable")


def _schur_select(which: str, theta_keep: np.ndarray):
    """A pointwise Schur-sort predicate that marks (at least) the kept set:
    'top p' as a threshold on the sort key; ties may select a few extra and
    the caller widens p to the returned ``sdim``."""
    eps = 1e-12
    if which == "LM":
        cut = np.abs(theta_keep).min()
        return lambda re, im: np.hypot(re, im) >= cut * (1 - eps) - eps
    if which == "SM":
        cut = np.abs(theta_keep).max()
        return lambda re, im: np.hypot(re, im) <= cut * (1 + eps) + eps
    if which == "LR":
        cut = theta_keep.real.min()
        return lambda re, im: re >= cut - eps - abs(cut) * eps
    if which == "SR":
        cut = theta_keep.real.max()
        return lambda re, im: re <= cut + eps + abs(cut) * eps
    if which == "LI":
        cut = np.abs(theta_keep.imag).min()
        return lambda re, im: abs(im) >= cut * (1 - eps) - eps
    raise ValueError(which)


def _shift_apply(op0, sigma, M, inner_tol, inner_max_iteration, inner_method):
    """``(apply, applied)``: ``apply(v)`` is w = (A - sigma I)^{-1} v by an
    inner Krylov solve, with the solve's converged flag; ``applied[0]``
    counts the applications of A - sigma I across the solves.  IDR(4) by
    default: sigma inside the spectrum's hull makes the shifted operator
    indefinite, where the JAX package measured BiCGStab breaking down and
    GMRES(40) stagnating (16^2 convection, eps 0.1, sigma 0.05) while
    IDR(4) converged every solve.  A ``Shards`` ``v`` (the mesh twin) runs
    ``parallel.shard_nonsym``'s sharded loop of the same method."""
    if inner_method not in ("idr", "bicgstab", "gmres"):
        raise ValueError(f"unknown inner_method {inner_method!r}")
    pol = ConvergencePolicy(tol=float(inner_tol), norm="rel_l2",
                            max_iteration=int(inner_max_iteration))
    applied = [0]

    def shifted(u):
        applied[0] += 1
        return op0(u) - sigma * u

    def apply(v):
        if isinstance(v, Shards):
            from conjugategradient_tpu_torch.parallel.shard_nonsym import run_sharded_loop

            res = run_sharded_loop(inner_method, shifted, M, v, torch.zeros_like(v), pol,
                                   v.numel() * v.mesh.size, restart=40, s=4)
        elif inner_method == "idr":
            res = idr_solve(shifted, v, policy=pol, M=M, s=4)
        elif inner_method == "gmres":
            res = gmres_solve(shifted, v, policy=pol, M=M, restart=40)
        else:
            res = bicgstab_solve(shifted, v, policy=pol, M=M)
        return res.x, bool(res.converged)

    return apply, applied


def _expand(apply_op, V, S, p: int, m: int, proj, dot):
    """The Arnoldi expansion from basis row ``p`` to ``m`` in place on
    ``V`` (m+1, n) and ``S`` (m, m): one ``apply_op`` a step, CGS2 against
    ``V[:j+1]`` (``proj(Vj, w)`` is ``Vj @ w``, ``dot`` the inner product:
    over a mesh their psum'd forms).  Returns ``(beta, ok)``: the last
    step's subdiagonal (a 0-d device tensor) and whether every inner solve
    converged."""
    eps = torch.finfo(V.dtype).eps
    ok = True
    wn = torch.zeros((), dtype=V.dtype, device=V.device)
    for j in range(p, m):
        w, w_ok = apply_op(V[j])
        ok = ok and w_ok
        Vj = V[: j + 1]
        h1 = proj(Vj, w)
        w = w - h1 @ Vj
        h2 = proj(Vj, w)
        w = w - h2 @ Vj
        h = h1 + h2
        wn = torch.sqrt(dot(w, w))
        # lucky-breakdown guard: after CGS2 the leftover w is rounding
        # noise whenever v_j's image lies in the basis span (wn ~ eps
        # ||A v_j||, never exactly 0; normalising it injects a garbage
        # direction: the JAX package measured beta = 225 from 1e-17
        # leftovers on the identity).  Zero it; the host truncates.
        live = wn > torch.sqrt(torch.sum(h * h)) * (100.0 * eps)
        wn = torch.where(live, wn, torch.zeros_like(wn))
        V[j + 1] = torch.where(live, _safe_div(torch.ones_like(wn), wn) * w, torch.zeros_like(w))
        # column j of S: h with the subdiagonal wn at row j+1; for j = m-1
        # that entry falls outside S: it is beta, carried separately
        S[:, j] = 0.0
        S[: j + 1, j] = h
        if j + 1 < m:
            S[j + 1, j] = wn
    return wn, ok


def _sharded_basis(A, n: int, m: int, dt, basis_sharding, is_callable_op, precise_dot):
    """The mesh twin's pieces: ``(mesh, op, rows, proj, dot, V)`` with
    ``op`` kernel #4 on each shard's extended DIA (``HaloDia``; a callable
    ``A`` takes ``Shards`` itself), ``rows`` a host (r, n) or (n,) array
    split into row blocks, ``proj``/``dot`` the psum'd CGS2 products and
    ``V`` the zero basis as ``Shards`` of (m+1, n / num)."""
    from conjugategradient_tpu_torch.core.formats import DiaMatrix
    from conjugategradient_tpu_torch.parallel.halo import HaloDia
    from conjugategradient_tpu_torch.parallel.mesh import psum, shard_rows

    mesh, axis = basis_sharding
    if mesh.ndim != 1 or axis != mesh.axis:
        raise ValueError(f"basis_sharding row-shards over a 1-D mesh's axis, not {axis!r} of "
                         f"{mesh}")
    mesh.one_process("arnoldi_eigs(basis_sharding=)")
    if n % mesh.size:
        raise ValueError(f"n={n} rows do not divide over {mesh.size} shards")
    n_local = n // mesh.size
    if is_callable_op:
        op = A
    elif isinstance(A, DiaMatrix):
        data = shard_rows(mesh, A.data, dt, dim=1)
        op = HaloDia(data, tuple(A.offsets), A.bandwidth, A.bandwidth > n_local)
    else:
        raise TypeError("basis_sharding= needs a DiaMatrix or a callable on Shards")
    rows = lambda a: shard_rows(mesh, torch.from_numpy(np.asarray(a)), dt, dim=-1)
    proj = lambda Vj, w: psum(Shards.map(torch.matmul, Vj, w)).parts[0]
    ldot = lambda a, b: _dot(a, b, precise=precise_dot)
    dot = lambda u, v: psum(Shards.map(ldot, u, v)).parts[0]
    V = Shards([torch.zeros((m + 1, n_local), dtype=dt, device=d) for d in mesh.local_devices],
               mesh)
    return mesh, op, rows, proj, dot, V


def arnoldi_eigs(
    A,
    k: int = 6,
    m: Optional[int] = None,
    which: str = "LM",
    tol: float = 1e-8,
    max_restarts: int = 60,
    sigma: Optional[float] = None,
    inner_tol: Optional[float] = None,
    inner_max_iteration: int = 10000,
    inner_method: str = "idr",
    n: Optional[int] = None,
    dtype=None,
    seed: int = 0,
    precise_dot: bool = False,
    M: Optional[Callable] = None,
    basis_sharding=None,
    device=None,
) -> EigsResult:
    """k eigenpairs of a square (nonsymmetric) operator by Krylov-Schur.

    ``A``: any matrix container or a callable ``v -> A @ v`` (pass ``n=``
    for callables).  ``which``: LM (largest magnitude, default) | SM | LR
    (rightmost) | SR (leftmost) | LI.  ``m``: Arnoldi subspace size
    (default ``max(20, 2k + 8)``, clamped to n).  ``tol`` is RELATIVE:
    converged when ``residual_i <= tol * max(|lambda_i|, 1e-300)``.

    ``sigma``: shift-invert, eigenvalues nearest ``sigma`` first (each
    matvec one inner solve of ``(A - sigma I) w = v`` to ``inner_tol`` by
    ``inner_method``: ``"idr"`` (IDR(4), default), ``"bicgstab"`` or
    ``"gmres"`` (GMRES(40)); ``M`` preconditions it).  ``which`` then
    applies to ``1 / (lambda - sigma)`` (LM = nearest to sigma); values are
    mapped back and residuals recomputed as ``||A x - lambda x||_2``.
    ``inner_tol`` defaults to 1e-10 in fp64 and 1e-3 in fp32 (the JAX
    package's fp32 default, 1e-6, is under the floor of the port's inner
    solves on grid operators: see the module docstring); check
    ``inner_converged``, and loosen ``inner_tol`` where it is False.

    ``dtype``: the solve's (``None``: A's, fp64 for a callable, as the JAX
    package runs under x64); ``device``: where it runs (``None``: the card
    when there is one).  A single-vector Krylov space finds a degenerate
    eigenvalue once: for clustered symmetric spectra use ``lobpcg``.  May
    return FEWER than k pairs (see ``EigsResult``).  ``basis_sharding``:
    ``(mesh, axis)``, the port's ``NamedSharding(mesh, P(None, axis))``:
    the basis row-sharded over a 1-D mesh (the module docstring), ``A`` a
    ``DiaMatrix`` (or a callable on ``Shards``), ``device`` the mesh's
    first.
    """
    if n is None:
        if hasattr(A, "n"):
            n = int(A.n)
        else:
            raise ValueError("pass n= when A is a callable operator")
    if k < 1:
        raise ValueError("k must be >= 1")
    if k >= n:
        raise ValueError(f"k={k} must be < n={n}")
    if m is None:
        m = max(20, 2 * k + 8)
    m = int(min(m, n))
    if m < k + 2:
        raise ValueError(f"subspace m={m} must be >= k+2={k + 2}")

    is_callable_op = callable(A) and not hasattr(A, "n")
    if dtype is None:
        dtype = getattr(A, "dtype", None) or torch.float64
    dt = torch_dtype(dtype)
    eps = float(torch.finfo(dt).eps)
    rng = np.random.default_rng(seed)
    v0 = rng.standard_normal(n)
    v0 /= np.linalg.norm(v0)
    if basis_sharding is not None:
        mesh, op_plain, rows, proj, dot, V = _sharded_basis(A, n, m, dt, basis_sharding,
                                                            is_callable_op, precise_dot)
        dev = mesh.local_devices[0]
        V[0] = rows(v0)
        gather = lambda X: X.gather(1)
    else:
        dev = default_device(device)
        if is_callable_op:
            op_plain = A
        else:
            A = prepare(A.device_put(dt, dev) if hasattr(A, "device_put") else A, dev)
            op_plain = as_operator(A)
        rows = lambda a: torch.from_numpy(np.asarray(a)).to(dev, dt)
        proj = lambda Vj, w: Vj @ w
        dot = lambda u, v: _dot(u, v, precise=precise_dot)
        V = torch.zeros((m + 1, n), dtype=dt, device=dev)
        V[0] = rows(v0)
        gather = lambda X: X

    inner_ok = True
    applied = [0]
    if sigma is not None:
        if inner_tol is None:
            # a true residual the port's inner solves reach in fp32 up to
            # 127^2 convection-diffusion (the module docstring)
            inner_tol = 1e-10 if dt == torch.float64 else 1e-3
        apply_op, applied = _shift_apply(op_plain, sigma, M, inner_tol, inner_max_iteration,
                                         inner_method)
    else:
        apply_op = lambda v: (op_plain(v), True)
    S = torch.zeros((m, m), dtype=dt, device=dev)

    # restart thickness: the k wanted plus half the discarded space (pure
    # k-keep restarts stall on clustered spectra); widened per cycle for
    # Schur-sort ties and 2x2 blocks
    p_keep = min(k + max(1, (m - k) // 2), m - 2)

    matvecs = 0
    theta = Y = None
    beta_f = 0.0
    mm = m  # effective subspace dimension (shrinks on lucky breakdown)
    wanted = np.arange(k)
    converged = False
    restarts = 0
    deflations = 0
    p_cur = 0

    with no_tf32():
        for restarts in range(1, max_restarts + 1):
            p = 0 if restarts == 1 else p_cur
            beta, ok_c = _expand(apply_op, V, S, p, m, proj, dot)
            matvecs += m - p
            # one read a cycle: S and beta together
            SB = torch.cat([S.reshape(-1), beta.reshape(1)]).to("cpu", torch.float64).numpy()
            S_np, beta_f = SB[:-1].reshape(m, m).copy(), float(SB[-1])
            if not np.isfinite(SB).all():
                raise FloatingPointError(
                    "non-finite Arnoldi basis: the operator gave non-finite values"
                    + ("" if sigma is None else ", or an inner solve diverged (an inner_tol "
                       "under the inner solver's floor in this dtype can do that)"))
            inner_ok = inner_ok and ok_c
            mm = m

            # lucky breakdown (invariant subspace): the guard zeroed every
            # later basis row; truncate to the invariant block (its Ritz
            # pairs are exact), or deflate-restart with a fresh random
            # direction orthogonalised against it when it is too small
            brk = 10.0 * eps * max(1.0, float(np.abs(S_np).max()))
            if beta_f <= brk:
                sub = np.abs(np.diag(S_np, -1))  # subdiagonal wn history
                tiny = [j for j in range(p, m - 1) if sub[j] <= brk]
                mm = (tiny[0] + 1) if tiny else m
                if mm < k and deflations < 8:
                    deflations += 1
                    w = rows(rng.standard_normal(n))
                    for _ in range(2):  # CGS2 against the invariant block
                        w = w - proj(V[:mm], w) @ V[:mm]
                    w = w / torch.sqrt(dot(w, w))
                    V[mm] = w
                    p_cur = mm
                    if restarts < max_restarts:
                        continue
                S_np = S_np[:mm, :mm]
                theta, Y = np.linalg.eig(S_np)
                order = _order(which, theta)
                wanted = order[: min(k, mm)]
                beta_f = 0.0  # exact invariant subspace: residuals are zero
                converged = mm >= k
                break

            theta, Y = np.linalg.eig(S_np)  # unit eigvec columns
            order = _order(which, theta)
            wanted = order[:k]
            resid = beta_f * np.abs(Y[m - 1, wanted])
            floor = np.maximum(np.abs(theta[wanted]), 1e-300)
            if np.all(resid <= tol * floor):
                converged = True
                break
            if restarts == max_restarts:
                break

            # Krylov-Schur contraction to the leading ordered-Schur block
            import scipy.linalg

            keep = order[:p_keep]
            T, Q, sdim = scipy.linalg.schur(
                S_np, output="real", sort=_schur_select(which, theta[keep])
            )
            p_cur = max(p_keep, int(sdim))
            p_cur = min(p_cur, m - 1)
            # never split a 2x2 (complex-pair) block
            if p_cur < m and abs(T[p_cur, p_cur - 1]) > 0:
                p_cur += 1
            if p_cur >= m:
                p_cur = m - 1
                if abs(T[p_cur, p_cur - 1]) > 0:
                    p_cur -= 1
            Q1 = torch.from_numpy(np.ascontiguousarray(Q[:, :p_cur])).to(dev, dt)  # (m, p)
            Vp = Q1.T @ V[:m]  # (p, n) contraction on the card
            vm = torch.clone(V[m])  # the residual direction continues the basis
            V[:] = 0
            V[:p_cur] = Vp
            V[p_cur] = vm
            S_new = np.zeros((m, m))
            S_new[:p_cur, :p_cur] = T[:p_cur, :p_cur]
            S_new[p_cur, :p_cur] = beta_f * Q[m - 1, :p_cur]  # coupling row b^T
            S = torch.from_numpy(S_new).to(dev, dt)

        # assemble the eigenpairs: x_i = V_mm^T y_i, two real matmuls
        Yw = Y[:, wanted]  # (mm, k') complex
        Yr = torch.from_numpy(np.ascontiguousarray(Yw.real)).to(dev, dt)
        Yi = torch.from_numpy(np.ascontiguousarray(Yw.imag)).to(dev, dt)
        XrXi = gather(torch.cat([Yr.T @ V[:mm], Yi.T @ V[:mm]])).to("cpu", torch.float64).numpy()
    kw_n = len(wanted)
    X = (XrXi[:kw_n] + 1j * XrXi[kw_n:]).T.astype(np.complex128)  # (n, k')
    nrm = np.linalg.norm(X, axis=0)
    nrm[nrm == 0] = 1.0
    X /= nrm
    vals = theta[wanted].astype(np.complex128)
    resid = beta_f * np.abs(Y[mm - 1, wanted]) / nrm
    if sigma is not None:
        # back-transform lambda = sigma + 1/theta, then recompute the
        # residuals against the original operator (the first-order map of
        # the transformed estimate misleads near the shift): the 2k' real
        # and imaginary columns as one block product, one read
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = sigma + 1.0 / theta[wanted]
        cols = np.concatenate([X.real.T, X.imag.T], axis=0)  # (2k', n)
        with no_tf32():
            if basis_sharding is not None and is_callable_op:
                AXc = torch.stack([A(rows(c)).gather() for c in cols])
            elif basis_sharding is not None:  # kernel #5 on each shard
                AXc = op_plain(rows(cols)).gather(1)
            elif is_callable_op:
                AXc = torch.stack([A(c) for c in rows(cols)])
            else:
                AXc = _as_multi_operator(A, dev)(rows(cols).contiguous())
        AX = AXc.to("cpu", torch.float64).numpy()
        Ax_c = AX[:kw_n].astype(np.complex128) + 1j * AX[kw_n:]
        resid = np.linalg.norm(Ax_c - vals[:, None] * X.T, axis=1).astype(np.float64)
    return EigsResult(
        values=vals,
        vectors=X,
        residuals=np.asarray(resid, np.float64),
        matvecs=matvecs,
        restarts=restarts,
        converged=bool(converged),
        inner_converged=bool(inner_ok),
        inner_matvecs=applied[0],
    )


def gspmd_arnoldi_eigs(A, k: int = 6, mesh=None, axis: str = "x", dtype=None,
                       **kw) -> EigsResult:
    """Mesh-distributed Krylov-Schur Arnoldi: ``arnoldi_eigs`` with the
    basis and A's DIA data row-sharded over ``axis`` of a 1-D ``mesh``
    (``basis_sharding=(mesh, axis)``; the module docstring).  The
    expansion's product is kernel #4 a shard; the ``m x m`` Schur work
    stays on the host.  The one-device trajectory up to the order of the
    psum'd partials.  ``A`` must be a ``DiaMatrix``; ``dtype`` defaults to
    its data's."""
    from conjugategradient_tpu_torch.core.formats import DiaMatrix

    if mesh is None:
        raise ValueError("gspmd_arnoldi_eigs needs a mesh")
    if not isinstance(A, DiaMatrix):
        raise TypeError("gspmd_arnoldi_eigs requires a DiaMatrix")
    if dtype is None:
        dtype = A.data.dtype if torch.is_tensor(A.data) else np.asarray(A.data).dtype
    return arnoldi_eigs(A, k, dtype=dtype, basis_sharding=(mesh, axis), **kw)
