"""Mixed-precision iterative refinement: fp64 tolerances from fp32 inner
solves on the card.

The port of ``conjugategradient_tpu/solvers/refine.py``:

    repeat:
        r = b - A x            (fp64: host numpy, or on the card)
        stop when ||r|| < tol  (the true residual, not the recurrence's)
        d = solve(A, r / s)    (fp32 CG on the card, relative inner_tol;
                                s = ||r||_inf keeps fp32 in range)
        x = x + s * d          (fp64)

Gridless, the inner CG runs on the DIA SpMV (kernel #4,
``ops.cuda_dia.spmv_dia_cuda``), with ``matrix_dtype=torch.bfloat16`` on its
bf16-leg instantiation; with ``grid=`` it is MGCG on the const-stencil
hierarchy of ``precond.multigrid``.  ``refined_solve_multi`` runs the
multi-RHS form over ``cg_solve_multi`` (kernel #5).

``device_residual=True`` keeps the outer loop on the card too.  The JAX
package does that in double-float (two-fp32) arithmetic, since the TPU has
no fp64; the H100 has native fp64, so here the residual, its norms, the
scaling and the update are plain fp64 tensor work, with ``b - A x`` on
kernel #4's fp64 instantiation over ``A.device_put(torch.float64)``, for the
gridless and the grid path alike.

``use_pallas`` is kept for parity and changes nothing: on the card every
DIA product runs the hand-written kernel, on the CPU its plain twin (see
``ops.spmv.as_operator``).  ``device`` says where the inner solves run.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops.spmv import spmv_dia
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, NotConvergedError

_SOLVER_FAMILIES = "ROADMAP queue 1 item 10 (solver families)"


@dataclasses.dataclass
class RefineResult:
    x: np.ndarray  # fp64 solution
    outer_iterations: int
    inner_iterations: int  # total inner CG iterations across passes
    residual: float  # true fp64 residual (selected norm)
    converged: bool
    history: list  # fp64 residual after each outer pass
    stalled: bool = False  # progress hit the fp64 evaluation noise floor
    #: host-clock seconds of the whole call: ``inner_s`` (the inner solves,
    #: each ending in its last device read) plus ``outer_s`` (everything
    #: else: setup, residuals, norms, transfers).  The device-residual path
    #: adds the JAX package's ``input_s`` (b and x0 to the card), ``exec_s``
    #: (the refinement loop) and ``output_s`` (the solution to the host).
    timings: Optional[dict] = None


def _check_inner(inner: str, deflation) -> None:
    if inner not in ("cg", "bicgstab"):
        raise ValueError(f"unknown inner {inner!r}; want cg|bicgstab")
    if inner == "bicgstab":
        raise NotImplementedError(f"inner='bicgstab' is not ported yet ({_SOLVER_FAMILIES})")
    if deflation is not None:
        raise NotImplementedError(f"deflation= is not ported yet ({_SOLVER_FAMILIES})")


def _inner_solver(A: DiaMatrix, grid, inner_tol, device_dtype, hierarchy, smoother,
                  matrix_dtype, device):
    """(solve(r) -> CGResult, shape of r): the fp32 inner CG, built once.

    Gridless: CG on ``A.device_put(matrix_dtype or device_dtype)``.  Grid:
    MGCG on the const-stencil hierarchy (``hierarchy``, on ``device``, or
    one built here; building needs the Galerkin product, which is not
    ported, so ``build_hierarchy`` raises).  Const-stencil levels ship no
    matrix bytes, so ``matrix_dtype`` does not apply there."""
    from conjugategradient_tpu_torch.precond.multigrid import (
        _REST_OF_HIERARCHY,
        as_preconditioner,
        build_hierarchy,
    )

    max_it = min(8 * A.n, 1_000_000)
    pol = ConvergencePolicy(tol=inner_tol, norm="rel_l2", max_iteration=max_it)
    prec = np.dtype(device_dtype) == np.float32
    if grid is not None:
        h = hierarchy
        if h is None:
            h = build_hierarchy(A, grid, smoother=smoother, dtype=device_dtype, device=device)
        if not h.levels:
            raise NotImplementedError(
                "a grid path without hierarchy levels needs the variable-coefficient "
                f"stencil operator (ROADMAP queue 2 kernel #3, {_REST_OF_HIERARCHY})"
            )
        A_dev, M = h.levels[0].A, as_preconditioner(h)
        return (lambda r: cg_solve(A_dev, r, policy=pol, M=M, precise_dot=prec)), tuple(grid)
    A_dev = A.device_put(matrix_dtype or device_dtype, device)
    return (lambda r: cg_solve(A_dev, r, policy=pol, precise_dot=prec)), (A.n,)


def refined_solve(
    A: DiaMatrix,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    tol: float = 1e-8,
    norm: str = "l2",
    grid: Optional[Tuple[int, ...]] = None,
    inner_tol: float = 1e-5,
    max_outer: int = 40,
    device_dtype=np.float32,
    hierarchy=None,
    smoother: str = "chebyshev",
    raise_on_divergence: bool = False,
    use_pallas: Optional[bool] = None,
    matrix_dtype=None,
    device_residual: bool = False,
    deflation=None,
    inner: str = "cg",
    device="cpu",
) -> RefineResult:
    """Solve A x = b to an fp64 tolerance using fp32 inner solves on
    ``device``.

    ``A``/``b`` are host fp64.  With ``grid`` the inner solver is MGCG on
    ``hierarchy`` (reused across passes); otherwise plain CG on the DIA
    kernel.  The returned residual is the *true* fp64 residual.  Each outer
    pass checks it; two consecutive passes that cut it by less than 10%
    declare ``stalled`` (the fp64 evaluation noise floor).

    ``matrix_dtype`` (gridless) stores the device matrix narrower than the
    Krylov state, e.g. ``torch.bfloat16`` with fp32 vectors: the kernel
    streams half the bytes and accumulates in fp32, the inner CG converges
    on the rounded operator, and the fp64 outer passes correct for it.

    ``device_residual=True`` runs the outer loop on the card in fp64 (see
    the module docstring); it needs ``device_dtype=float32``.
    ``inner="bicgstab"`` and ``deflation`` are not ported yet.
    """
    _check_inner(inner, deflation)
    if device_residual:
        return _refined_solve_device(
            A, b, x0, tol=tol, norm=norm, grid=grid, inner_tol=inner_tol,
            max_outer=max_outer, device_dtype=device_dtype, hierarchy=hierarchy,
            smoother=smoother, raise_on_divergence=raise_on_divergence,
            use_pallas=use_pallas, matrix_dtype=matrix_dtype, device=device,
        )

    t_start = time.perf_counter()
    n = A.n
    b64 = np.asarray(b, dtype=np.float64)
    x = np.zeros(n) if x0 is None else np.asarray(x0, dtype=np.float64).copy()
    solve, shape = _inner_solver(A, grid, inner_tol, device_dtype, hierarchy, smoother,
                                 matrix_dtype, device)

    def true_residual(x):
        r = b64 - oracle.spmv(A, x)
        return r, oracle.residual_norm(r, float(r @ r), rr0, norm)

    r0 = b64 - oracle.spmv(A, x)
    rr0 = float(r0 @ r0)

    history = []
    inner_total = 0
    inner_s = 0.0
    stall_count = 0

    def finish(outer, res, converged, stalled=False):
        total = time.perf_counter() - t_start
        return RefineResult(x, outer, inner_total, res, converged, history, stalled,
                            timings={"inner_s": inner_s, "outer_s": total - inner_s})

    for outer in range(max_outer):
        r, res = true_residual(x)
        history.append(res)
        if res < tol:
            return finish(outer, res, True)
        if len(history) >= 2 and res > 0.9 * history[-2]:
            stall_count += 1
            if stall_count >= 2:
                return finish(outer, res, False, stalled=True)
        else:
            stall_count = 0
        s = float(np.max(np.abs(r)))
        if s == 0.0:
            return finish(outer, 0.0, True)
        r_dev = torch.from_numpy((r / s).astype(device_dtype)).to(device).reshape(shape)
        t0 = time.perf_counter()
        dres = solve(r_dev)
        d_host = dres.x.reshape(-1).cpu().numpy()
        inner_s += time.perf_counter() - t0
        inner_total += int(dres.iterations)
        x = x + s * d_host.astype(np.float64)

    r, res = true_residual(x)
    history.append(res)
    if raise_on_divergence and res >= tol:
        raise NotConvergedError(
            f"iterative refinement: {max_outer} outer passes, residual {res:.3e}"
        )
    return finish(max_outer, res, res < tol)


def _refined_solve_device(
    A: DiaMatrix,
    b: np.ndarray,
    x0: Optional[np.ndarray] = None,
    tol: float = 1e-8,
    norm: str = "l2",
    grid: Optional[Tuple[int, ...]] = None,
    inner_tol: float = 1e-5,
    max_outer: int = 40,
    device_dtype=np.float32,
    hierarchy=None,
    smoother: str = "chebyshev",
    raise_on_divergence: bool = False,
    use_pallas: Optional[bool] = None,
    matrix_dtype=None,
    device="cpu",
) -> RefineResult:
    """Device-resident refinement: the outer loop's fp64 work (residual,
    norms, scaling, update) runs on ``device`` in fp64, with ``b - A x`` on
    kernel #4's fp64 instantiation.  The scaled fp32 residual never leaves
    the card; the solution is read back once, at the end."""
    if np.dtype(device_dtype) != np.float32:
        raise ValueError("device_residual requires device_dtype=float32 "
                         "(fp32 inner solves under an fp64 outer pass)")
    t_start = time.perf_counter()
    n = A.n
    solve, shape = _inner_solver(A, grid, inner_tol, device_dtype, hierarchy, smoother,
                                 matrix_dtype, device)
    A64 = A.device_put(torch.float64, device)

    t0 = time.perf_counter()
    b64 = torch.from_numpy(np.asarray(b, dtype=np.float64)).to(device)
    x64 = (torch.zeros(n, dtype=torch.float64, device=device) if x0 is None
           else torch.from_numpy(np.asarray(x0, dtype=np.float64)).to(device))
    if b64.device.type == "cuda":
        torch.cuda.synchronize(b64.device)
    input_s = time.perf_counter() - t0

    def resid(b_, x_):
        r = b_ - spmv_dia(A64, x_)
        mx = torch.max(torch.abs(r))
        s = torch.where(mx > 0, mx, torch.ones_like(mx))
        return (r / s).to(torch.float32).reshape(shape), torch.dot(r, r), mx

    def update(x_, r32, s):
        d = solve(r32)
        return x_ + s * d.x.reshape(-1).to(torch.float64), d.iterations

    res = run_device_refinement(resid, update, b64, x64, tol=tol, norm=norm,
                                max_outer=max_outer, raise_on_divergence=raise_on_divergence)
    res.timings["input_s"] = input_s
    res.timings["outer_s"] = time.perf_counter() - t_start - res.timings["inner_s"]
    return res


def run_device_refinement(
    resid_fn,
    update_fn,
    b,
    x,
    tol: float,
    norm: str,
    max_outer: int,
    raise_on_divergence: bool = False,
) -> RefineResult:
    """THE device-resident refinement outer loop.

    ``resid_fn(b, x) -> (r32_scaled, rr, mx)``: the fp64 residual, its norm
    squared and max-abs (0-d device tensors), and the inf-norm-scaled fp32
    residual, which stays on the card.  ``update_fn(x, r32, s) -> (x,
    inner_its)``: the inner solve and the fp64 update.  Per pass the host
    reads three scalars: rr and mx in one transfer, and the inner iteration
    count, which the port's Python-loop CG already holds as a host integer.
    The solution is read back once, at the end.  Stall rule: two consecutive
    passes that cut the residual by less than 10% declare ``stalled``.
    """

    def res_of(rr, mx, rr0):
        if norm == "l2":
            return float(np.sqrt(max(rr, 0.0)))
        if norm == "linf":
            return float(mx)
        if norm == "rel_l2":
            return float(np.sqrt(max(rr, 0.0) / (rr0 if rr0 > 0 else 1.0)))
        raise ValueError(f"unknown norm {norm!r}")

    t_loop0 = time.perf_counter()
    inner_s = 0.0
    history: list = []
    inner_total = 0
    stall_count = 0
    rr0 = None

    def finish(x, outer, res, converged, stalled=False):
        exec_s = time.perf_counter() - t_loop0
        t0 = time.perf_counter()
        x_host = x.reshape(-1).cpu().numpy()
        output_s = time.perf_counter() - t0
        if raise_on_divergence and not converged:
            raise NotConvergedError(
                f"iterative refinement: {outer} outer passes, residual {res:.3e}"
            )
        timings = {"exec_s": exec_s, "output_s": output_s, "inner_s": inner_s,
                   "outer_s": exec_s + output_s - inner_s}
        return RefineResult(x_host, outer, inner_total, res, converged, history,
                            stalled=stalled, timings=timings)

    for outer in range(max_outer):
        r32, rr_a, mx_a = resid_fn(b, x)
        rr, mx = torch.stack([rr_a, mx_a]).tolist()  # one transfer for both
        if rr0 is None:
            rr0 = rr
        res = res_of(rr, mx, rr0)
        history.append(res)
        if res < tol:
            return finish(x, outer, res, True)
        if len(history) >= 2 and res > 0.9 * history[-2]:
            stall_count += 1
            if stall_count >= 2:
                return finish(x, outer, res, False, stalled=True)
        else:
            stall_count = 0
        if mx == 0.0:
            return finish(x, outer, 0.0, True)
        t0 = time.perf_counter()
        x, its = update_fn(x, r32, mx)
        inner_s += time.perf_counter() - t0
        inner_total += int(its)

    _, rr_a, mx_a = resid_fn(b, x)
    rr, mx = torch.stack([rr_a, mx_a]).tolist()
    res = res_of(rr, mx, rr0 if rr0 is not None else 1.0)
    history.append(res)
    return finish(x, max_outer, res, res < tol)


@dataclasses.dataclass
class RefineMultiResult:
    x: np.ndarray  # (n, k) fp64 solutions
    outer_iterations: int
    inner_iterations: np.ndarray  # (k,) total inner iterations per column
    residual: np.ndarray  # (k,) true fp64 residuals (selected norm)
    converged: np.ndarray  # (k,) bool
    history: list  # (k,) residual array after each outer pass
    stalled: np.ndarray  # (k,) bool — column hit the fp64 noise floor


def refined_solve_multi(
    A: DiaMatrix,
    B: np.ndarray,
    X0: Optional[np.ndarray] = None,
    tol: float = 1e-8,
    norm: str = "l2",
    grid: Optional[Tuple[int, ...]] = None,
    inner_tol: float = 1e-5,
    max_outer: int = 40,
    device_dtype=np.float32,
    hierarchy=None,
    smoother: str = "chebyshev",
    use_pallas: Optional[bool] = None,
    matrix_dtype=None,
    device="cpu",
) -> RefineMultiResult:
    """Multi-RHS iterative refinement: solve A X = B, B of shape (n, k), to
    an fp64 tolerance with fp32 multi-RHS CG inner solves on ``device``.

    The outer loop is the single-RHS recurrence per column (fp64 host
    residual, per-column inf-norm scaling, the two-pass stall rule); every
    inner solve is one ``cg_solve_multi`` over the whole block, so the matrix
    streams once per iteration for all k columns (kernel #5).  Converged and
    stalled columns are frozen: their residual columns enter the inner solve
    as exact zeros and their updates are masked.  Gridless only: the grid
    path needs ``as_multi_preconditioner``, not ported yet.
    """
    if grid is not None:
        raise NotImplementedError(
            "refined_solve_multi with grid= needs the multi-RHS V-cycle "
            "(as_multi_preconditioner), not ported yet (ROADMAP queue 1 item 8)"
        )
    n = A.n
    B64 = np.asarray(B, dtype=np.float64)
    if B64.ndim != 2 or B64.shape[0] != n:
        raise ValueError(f"B must be (n, k) = ({n}, k), got {B64.shape}")
    k = B64.shape[1]
    X = np.zeros((n, k)) if X0 is None else np.asarray(X0, dtype=np.float64).reshape(n, k).copy()

    A_dev = A.device_put(matrix_dtype or device_dtype, device)
    max_it = min(8 * n, 1_000_000)
    pol = ConvergencePolicy(tol=inner_tol, norm="rel_l2", max_iteration=max_it)

    def spmm64(X):
        return np.stack([oracle.spmv(A, X[:, j]) for j in range(k)], axis=1)

    R0 = B64 - spmm64(X)
    rr0 = np.sum(R0 * R0, axis=0)

    def col_norms(R):
        rr = np.sum(R * R, axis=0)
        if norm == "l2":
            return np.sqrt(rr)
        if norm == "linf":
            return np.abs(R).max(axis=0) if R.size else np.zeros(k)
        if norm == "rel_l2":
            return np.sqrt(rr / np.where(rr0 > 0, rr0, 1.0))
        raise ValueError(f"unknown norm {norm!r}")

    history: list = []
    inner_total = np.zeros(k, dtype=np.int64)
    stall_count = np.zeros(k, dtype=np.int64)
    stalled = np.zeros(k, dtype=bool)
    for outer in range(max_outer):
        R = B64 - spmm64(X)
        res = col_norms(R)
        history.append(res)
        conv = res < tol
        if len(history) >= 2:
            no_progress = res > 0.9 * history[-2]
            stall_count = np.where(no_progress, stall_count + 1, 0)
            stalled = stalled | ((stall_count >= 2) & ~conv)
        active = ~conv & ~stalled
        if not active.any():
            return RefineMultiResult(X, outer, inner_total, res, conv, history, stalled)
        s = np.abs(R).max(axis=0)
        s = np.where(active & (s > 0), s, 1.0)
        Rs = np.where(active[None, :], R / s[None, :], 0.0)
        dres = cg_solve_multi(A_dev, torch.from_numpy(Rs.astype(device_dtype)).to(device),
                              policy=pol, use_pallas=bool(use_pallas))
        inner_total += np.where(active, dres.iterations.cpu().numpy(), 0)
        D = dres.x.cpu().numpy().astype(np.float64)
        X = X + np.where(active[None, :], s[None, :], 0.0) * D

    R = B64 - spmm64(X)
    res = col_norms(R)
    history.append(res)
    return RefineMultiResult(X, max_outer, inner_total, res, res < tol, history, stalled)
