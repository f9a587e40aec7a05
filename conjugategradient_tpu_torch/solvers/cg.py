"""(Preconditioned) Conjugate Gradient on device tensors.

The recurrence lives in one place, ``_make_step``, and three drivers share
it, as in the JAX package:

- ``cg_solve``: a Python loop (PyTorch has no ``lax.while_loop``).  α, β,
  r·z and r·r stay 0-d device tensors, and the host reads one device scalar
  per iteration, the ``residual >= tol`` half of the convergence predicate
  (the iteration bounds are host integers).  The predicate is checked
  before the body: ``min_iteration`` is inclusive and ``max_iteration``
  comes from ``ConvergencePolicy.resolve_max``.
- ``cg_solve_traced``: ``num_steps`` masked steps with no host read, the
  residual history (and the Lanczos coefficients) written into
  preallocated device tensors.
- ``cg_solve_chunked``: masked chunks of a fixed trip count with one
  batched host read per chunk, a checkpoint file and a progress callback.
  On the card each chunk is one CUDA graph, captured once per call and
  replayed per chunk: the port's ``jax.jit(run_chunk)``.

A masked step runs the whole recurrence and selects the old state where the
mask is off (``torch.where``, exact), so a frozen step changes nothing and
a fixed trip count stops where ``cg_solve`` stops.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.core.formats import is_host
from conjugategradient_tpu_torch.ops.blas import dot as _dot
from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.ops.cuda_dia import (
    launch_counts,
    spmv_dia_batched_cuda,
    spmv_dot_dia_batched_cuda,
)
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, NotConvergedError


@dataclasses.dataclass(frozen=True)
class CGResult:
    """Solve outcome.  ``converged=False`` means max_iteration was exhausted;
    ``raise_if_diverged()`` turns that into an exception.  A batched solve
    (``cg_solve_batched``) carries a leading k axis in every field:
    iterations, residual and converged are then ``(k,)`` tensors."""

    x: torch.Tensor
    iterations: int
    residual: torch.Tensor  # 0-d, in the solve's dtype
    converged: bool

    def raise_if_diverged(self) -> "CGResult":
        if not bool(torch.as_tensor(self.converged).all()):
            res = torch.as_tensor(self.residual)
            shown = f"{float(res):.3e}" if res.ndim == 0 else str(res.tolist())
            raise NotConvergedError(
                f"CG did not converge within {self.iterations} iterations (residual={shown})"
            )
        return self


def _safe_div(num, den):
    """num/den with 0 when den == 0 (keeps the loop NaN-free when the initial
    guess is already exact and min_iteration forces extra sweeps)."""
    ok = den != 0
    return torch.where(ok, num, torch.zeros_like(num)) / torch.where(ok, den, torch.ones_like(den))


def _apply_M(M, r):
    """Preconditioner application.  ``M`` is a callable z = M(r), or a
    ``(fn, state)`` pair applied as ``fn(state, r)``, as in the JAX
    package (the form ``cg_solve_chunked`` hands its chunk)."""
    if M is None:
        return r
    if isinstance(M, tuple):
        fn, state = M
        return fn(state, r)
    return M(r)


def _cg_init(op, b, x0, M, dot, dtype, project=None, project_r=None):
    """Initial recurrence state (x, r, p, rz, rr) from b and the guess."""
    x = torch.zeros_like(b) if x0 is None else x0.to(dtype)
    r = b - op(x)
    if project_r is not None:
        r = project_r(r)
    z = _apply_M(M, r)
    p = z if project is None else project(z)
    rz = dot(r, z)
    rr = dot(r, r)
    return x, r, p, rz, rr


def _make_step(op, M, dot, project=None, project_r=None):
    """THE CG recurrence, written once: ``step(x, r, p, rz, rr) ->
    ((x, r, p, rz, rr), (alpha, beta))``, one unconditional iteration,
    NaN-free at exact convergence via ``_safe_div``.

    ``project`` (optional) maps the preconditioned residual before it
    enters the direction update: the hook deflated CG uses to keep every
    search direction A-orthogonal to the deflation space
    (``solvers.deflation``).  ``project_r`` (optional) re-projects the
    residual after every update (``r - AW E^-1 W^T r``, which zeroes
    ``W^T r``): the DEF-form stabilisation, load-bearing in fp32, whose
    removed solution components the caller restores afterwards
    (``deflated_cg_solve``).  Both are the identity when None, and the
    step is then the plain recurrence, op for op."""

    def step(x, r, p, rz, rr):
        Ap = op(p)
        alpha = _safe_div(rz, dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        if project_r is not None:
            r = project_r(r)
        z = _apply_M(M, r)
        rz_new = dot(r, z)
        rr_new = dot(r, r)
        beta = _safe_div(rz_new, rz)
        p = (z if project is None else project(z)) + beta * p
        return (x, r, p, rz_new, rr_new), (alpha, beta)

    return step


def _setup(A, b, precise_dot, use_pallas):
    """(operator, dot) of a solve on ``b``'s device, a host container
    placed there first."""
    if is_host(A):
        A = A.device_put(device=b.device)
    dot = lambda u, v: _dot(u, v, precise=precise_dot)
    return as_operator(A, use_pallas=use_pallas), dot


def cg_solve(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
    project: Optional[Callable] = None,
    project_r: Optional[Callable] = None,
) -> CGResult:
    """Solve A x = b by (preconditioned) CG on ``b``'s device.

    ``A`` is any container of ``core.formats`` (a host one is placed on
    ``b``'s device, its dtype kept) or a callable; ``b`` may be flat or
    grid-shaped.
    ``use_pallas`` is kept for parity and changes nothing: a CUDA ``b``
    always runs the hand-written kernels, a CPU ``b`` their twins
    (``ops.spmv.as_operator``).  fp32 with an absolute norm can underflow
    ``r`` long before the true residual is meaningful: for plain fp32 solves
    prefer ``norm="rel_l2"``, or ``solvers.refine.refined_solve``.
    ``project`` and ``project_r`` are the deflation hooks of
    ``_make_step``; a caller of ``project_r`` restores the deflated
    solution components afterwards (``deflated_cg_solve`` does).
    """
    op, dot = _setup(A, b, precise_dot, use_pallas)
    dtype = b.dtype
    tol = torch.tensor(policy.tol, dtype=dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(b.numel())

    x, r, p, rz, rr = _cg_init(op, b, x0, M, dot, dtype, project=project, project_r=project_r)
    rr0 = rr

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    step = _make_step(op, M, dot, project=project, project_r=project_r)
    it = 0
    while it < max_iter and (it < min_iter or bool(res_of(r, rr) >= tol)):
        (x, r, p, rz, rr), _coeffs = step(x, r, p, rz, rr)
        it += 1
    res = res_of(r, rr)
    converged = bool(res < tol) and it >= min_iter
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def _make_masked_step(op, M, dot):
    """Fixed-trip-count variant: ``step(state, active) -> (state, (alpha,
    beta))`` with ``state = (x, r, p, rz, rr, it)``, ``active`` a 0-d bool
    tensor and ``it`` an int32 one.  Where ``active`` is False the old state
    is selected (``torch.where``: exact, never blended), so iterations after
    convergence are no-ops and the scalars of frozen steps are meaningless
    (consumers truncate by the final iteration count)."""
    raw = _make_step(op, M, dot)

    def step(state, active):
        x, r, p, rz, rr, it = state
        new, coeffs = raw(x, r, p, rz, rr)
        kept = tuple(torch.where(active, a, b) for a, b in zip(new, (x, r, p, rz, rr)))
        return (*kept, it + active.to(torch.int32)), coeffs

    return step


def cg_solve_traced(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    num_steps: int = 100,
    precise_dot: bool = False,
    use_pallas: bool = False,
    with_coefficients: bool = False,
):
    """Fixed-length CG that records the residual after every iteration.

    Runs ``num_steps`` masked steps with no host read inside the loop and
    writes the residual history into a preallocated ``(num_steps,)`` device
    tensor; iterations after convergence freeze the state, so the history's
    tail is flat.  As in the JAX package ``max_iteration`` is not applied:
    ``num_steps`` alone bounds the run.

    Returns ``(CGResult, history)``, or with ``with_coefficients=True``
    ``(CGResult, history, (alphas, betas))``: the recurrence scalars of
    every step, the Lanczos coefficients of the (preconditioned) operator.
    Entries past ``iterations`` come from frozen steps; truncate before use.
    """
    op, dot = _setup(A, b, precise_dot, use_pallas)
    dtype = b.dtype
    tol = torch.tensor(policy.tol, dtype=dtype, device=b.device)
    x, r, p, rz, rr = _cg_init(op, b, x0, M, dot, dtype)
    rr0 = rr

    def res_of(r, rr):
        return residual_norm(r, rr, rr0, policy.norm)

    masked = _make_masked_step(op, M, dot)
    history = torch.empty(num_steps, dtype=dtype, device=b.device)
    alphas = torch.empty_like(history)
    betas = torch.empty_like(history)
    state = (x, r, p, rz, rr, torch.zeros((), dtype=torch.int32, device=b.device))
    for k in range(num_steps):
        _, r, _, _, rr, it = state
        active = (it < policy.min_iteration) | (res_of(r, rr) >= tol)
        state, (alpha, beta) = masked(state, active)
        history[k] = res_of(state[1], state[4])
        alphas[k] = alpha
        betas[k] = beta
    x, r, p, rz, rr, it = state
    res = res_of(r, rr)
    iterations = int(it)
    result = CGResult(x=x, iterations=iterations, residual=res,
                      converged=bool(res < tol) and iterations >= policy.min_iteration)
    if with_coefficients:
        return result, history, (alphas, betas)
    return result, history


def _chunk_runner(op, M, dot, tol, min_iter, max_iter, norm, rr0):
    """``run(state, steps) -> (state, status)``: ``steps`` masked steps
    under the chunked driver's stop rule, then the float64 status vector
    ``[it, residual, continue, converged, rz, rr, rr0]`` that the host
    reads once per chunk."""
    masked = _make_masked_step(op, M, dot)

    def more(r, rr, it):
        res = residual_norm(r, rr, rr0, norm)
        return ((it < min_iter) | (res >= tol)) & (it < max_iter), res

    def run(state, steps):
        for _ in range(steps):
            _, r, _, _, rr, it = state
            state, _coeffs = masked(state, more(r, rr, it)[0])
        _, r, _, rz, rr, it = state
        go, res = more(r, rr, it)
        done = (res < tol) & (it >= min_iter)
        f64 = torch.float64
        status = torch.stack([it.to(f64), res.to(f64), go.to(f64), done.to(f64), rz.to(f64),
                              rr.to(f64), rr0.to(f64)])
        return state, status

    return run


def _graph_chunk(run, bufs, status, chunk, stats):
    """Capture ``chunk`` masked steps over the static buffers ``bufs``
    (x, r, p, rz, rr, it) and ``status`` into one CUDA graph, whose replay
    advances them in place.  One warm-up step runs first on the capture's
    side stream (lazy builds, library handles and workspaces must exist
    before capture); the step is functional, so its discarded result leaves
    the Krylov state where it was.  The capture is begun and ended directly
    (``torch.cuda.graph`` would also empty the allocator's cache, so every
    later allocation of the solve would go back to ``cudaMalloc``).  A
    capture that fails raises: the chunk never falls back to eager
    launches."""
    dev = bufs[0].device
    before = launch_counts()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.stream(side):
            run(bufs, 1)
            warm = launch_counts()
            t0 = time.perf_counter()
            graph.capture_begin()
            try:
                state, st = run(bufs, chunk)
                for buf, new in zip(bufs, state):
                    buf.copy_(new)
                status.copy_(st)
            except BaseException:
                with contextlib.suppress(RuntimeError):  # ends the invalidated capture
                    graph.capture_end()
                raise
            graph.capture_end()
    except RuntimeError as e:
        raise RuntimeError(
            f"cg_solve_chunked: capturing the masked chunk as a CUDA graph failed ({e}); the "
            "operator and the preconditioner must run without host reads or syncs"
        ) from e
    torch.cuda.current_stream(dev).wait_stream(side)
    stats["capture_s"] = time.perf_counter() - t0
    after = launch_counts()
    stats["warmup_launches"] = {k: v - before[k] for k, v in warm.items() if v > before[k]}
    stats["launches_per_chunk"] = {k: v - warm[k] for k, v in after.items() if v > warm[k]}
    return graph


def cg_solve_chunked(
    A,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    M: Optional[Callable] = None,
    chunk: int = 200,
    checkpoint_path: Optional[str] = None,
    resume: bool = True,
    callback: Optional[Callable] = None,
    precise_dot: bool = False,
    use_pallas: bool = False,
    stats: Optional[dict] = None,
) -> CGResult:
    """Checkpointable CG: ``chunk`` masked iterations at a time, with one
    batched host read between chunks.

    The stop rule is the JAX package's: an iteration runs while ``(it <
    min_iteration or residual >= tol) and it < max_iteration`` (the cap from
    ``ConvergencePolicy.resolve_max``, int32-clamped), so the count equals
    ``cg_solve``'s.  On a CUDA ``b`` the chunk is one CUDA graph, captured
    once per call and replayed per chunk; on a CPU ``b`` the same masked
    steps run eagerly.  A capture that fails raises with the reason.

    Between chunks the host state (``utils.checkpoint.CGState``: x, r and p
    downloaded) is built only when ``checkpoint_path`` or ``callback`` reads
    it: it is saved atomically to ``checkpoint_path``, and a later call with
    the same path (``resume=True``) continues the same Krylov sequence,
    surviving process death mid-solve.  ``callback(state)`` receives it per
    chunk.  ``M`` is a callable or a ``(fn, state)`` pair.

    ``stats``, a dict, is filled with ``chunks`` (host reads; on the card,
    graph replays), ``capture_s`` (seconds to capture the graph, apart from
    its replays), ``save_s`` (checkpoint writes) and the kernel launches that
    the wrappers counted in the warm-up step and in the captured chunk
    (``warmup_launches``, ``launches_per_chunk``): a wrapper counts a
    captured launch once, however often the graph replays it.
    """
    from conjugategradient_tpu_torch.utils import checkpoint as ckpt

    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    op, dot = _setup(A, b, precise_dot, use_pallas)
    dtype, dev = b.dtype, b.device
    tol = torch.tensor(policy.tol, dtype=dtype, device=dev)
    prev = ckpt.maybe_resume(checkpoint_path) if resume else None
    if prev is not None:
        vec = lambda v: torch.as_tensor(v, dtype=dtype).reshape(b.shape).to(dev)
        num = lambda v: torch.tensor(v, dtype=dtype, device=dev)
        x, r, p = vec(prev.x), vec(prev.r), vec(prev.p)
        rz, rr, rr0 = num(prev.rz), num(prev.rr), num(prev.rr0)
        it = torch.tensor(prev.iteration, dtype=torch.int32, device=dev)
    else:
        x, r, p, rz, rr = _cg_init(op, b, x0, M, dot, dtype)
        rr0 = rr
        it = torch.zeros((), dtype=torch.int32, device=dev)
    run = _chunk_runner(op, M, dot, tol, policy.min_iteration, policy.resolve_max(b.numel()),
                        policy.norm, rr0)
    stats = {} if stats is None else stats
    stats.update(chunks=0, capture_s=0.0, save_s=0.0, warmup_launches={}, launches_per_chunk={})
    graph = None
    if dev.type == "cuda":
        # static buffers: the graph reads and writes these addresses
        bufs = tuple(t.clone() for t in (x, r, p, rz, rr, it))
        status = torch.empty(7, dtype=torch.float64, device=dev)
        graph = _graph_chunk(run, bufs, status, chunk, stats)
    else:
        bufs = (x, r, p, rz, rr, it)
    while True:
        if graph is not None:
            graph.replay()
        else:
            bufs, status = run(bufs, chunk)
        it_f, _, go, done, rz_f, rr_f, rr0_f = status.tolist()
        stats["chunks"] += 1
        if checkpoint_path or callback is not None:
            x, r, p = bufs[:3]
            state = ckpt.CGState(x=x.cpu().numpy(), r=r.cpu().numpy(), p=p.cpu().numpy(),
                                 rz=rz_f, rr=rr_f, rr0=rr0_f, iteration=int(it_f))
            if checkpoint_path:
                t0 = time.perf_counter()
                ckpt.save_state(checkpoint_path, state)
                stats["save_s"] += time.perf_counter() - t0
            if callback is not None:
                callback(state)
        if not go:
            break
    x, r, p, rz, rr, _ = bufs
    return CGResult(x=x, iterations=int(it_f), residual=residual_norm(r, rr, rr0, policy.norm),
                    converged=bool(done))


# ---------------------------------------------------------------------------
# (k, n) blocks: k recurrences at once, one per row
# ---------------------------------------------------------------------------


def columns_dot(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The ``(k,)`` dots of the rows of two ``(k, n)`` blocks."""
    return torch.sum(U * V, dim=1)


def columns_linf(R: torch.Tensor) -> torch.Tensor:
    """The ``(k,)`` max-abs norms of the rows of a ``(k, n)`` block."""
    return torch.amax(torch.abs(R), dim=1)


def block_residual(policy: ConvergencePolicy, rr0: torch.Tensor,
                   linf: Callable = columns_linf) -> Callable:
    """``res_of(R, rr)``: the ``(k,)`` residuals of a ``(k, n)`` block in
    the policy's norm from its squared norms ``rr`` (a row whose ``rr0`` is
    0 takes 1 for it); ``linf`` gives the max-abs norms."""

    def res_of(R, rr):
        if policy.norm == "l2":
            return torch.sqrt(rr)
        if policy.norm == "linf":
            return linf(R)
        if policy.norm == "rel_l2":
            return torch.sqrt(rr / torch.where(rr0 == 0, torch.ones_like(rr0), rr0))
        raise ValueError(policy.norm)

    return res_of


def cg_block(op: Callable, op_dot: Callable, B: torch.Tensor, X: Optional[torch.Tensor],
             policy: ConvergencePolicy, M: Optional[Callable] = None,
             dot: Callable = columns_dot, linf: Callable = columns_linf,
             n_global: Optional[int] = None):
    """THE per-row CG of a ``(k, n)`` block, shared by ``cg_solve_multi``,
    ``cg_solve_batched`` and the sharded block solvers of
    ``parallel.shard_multi``: ``op(X) -> A X`` (the initial residual) and
    ``op_dot(P) -> (A P, the (k,) dots p . Ap)`` row by row, ``M`` an
    optional ``(k, n) -> (k, n)`` preconditioner, ``X`` the start
    (``None``: zeros).  Each row runs its own scalars and
    ``max_iteration``; a row that has converged (or run out) freezes under
    masked updates (``torch.where``: exact) until every row is done, and the
    host reads one device scalar per iteration (whether any row is still
    active).  Returns ``(X, iterations, residual, converged)``, each with
    the leading k axis.

    The sharded hooks, the JAX package's ``psum_axis``/``n_global``: the
    block may be a ``parallel.mesh.Shards`` of row blocks, ``dot`` and
    ``linf`` then give the ``(k,)`` column dots and max-abs norms through
    one ``psum``/``pmax`` each (a plain tensor on the first shard's
    device), and ``n_global`` is the system's size for ``resolve_max``."""
    dev = B.device
    n = B.shape[1] if n_global is None else n_global
    tol = torch.tensor(policy.tol, dtype=B.dtype, device=dev)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n)
    cexp = lambda s: s[:, None]

    X = torch.zeros_like(B) if X is None else X
    R = B - op(X)
    Z = M(R) if M is not None else R
    P = Z
    rz = dot(R, Z)
    rr = dot(R, R)
    res_of = block_residual(policy, rr, linf)
    it = torch.zeros(B.shape[0], dtype=torch.int32, device=dev)

    def active_of(R, rr, it):
        return ((it < min_iter) | (res_of(R, rr) >= tol)) & (it < max_iter)

    while True:
        active = active_of(R, rr, it)
        if not bool(active.any()):
            break
        AP, pap = op_dot(P)
        zero = torch.zeros_like(rz)
        alpha = torch.where(active, _safe_div(rz, pap), zero)
        X = X + cexp(alpha) * P
        R2 = R - cexp(alpha) * AP
        Z2 = M(R2) if M is not None else R2
        rz2 = dot(R2, Z2)
        rr2 = dot(R2, R2)
        beta = torch.where(active, _safe_div(rz2, rz), zero)
        P = torch.where(cexp(active), Z2 + cexp(beta) * P, P)
        rz = torch.where(active, rz2, rz)
        rr = torch.where(active, rr2, rr)
        R = torch.where(cexp(active), R2, R)
        it = it + active.to(torch.int32)
    res = res_of(R, rr)
    return X, it, res, (res < tol) & (it >= min_iter)


def check_batched(data: torch.Tensor, offsets, shape, B: torch.Tensor) -> None:
    """Raise unless ``data`` ``(k, ndiags, n)`` on ``offsets`` and ``B``
    ``(k, n)`` make k square DIA systems of ``shape``."""
    if data.ndim != 3 or B.ndim != 2:
        raise ValueError(f"batched solve: data must be (k, ndiags, n) and B (k, n), got "
                         f"{tuple(data.shape)} and {tuple(B.shape)}")
    k, nd, n = data.shape
    if tuple(shape) != (n, n) or tuple(B.shape) != (k, n) or nd != len(offsets):
        raise ValueError(f"batched solve: data {tuple(data.shape)}, {len(offsets)} offsets, shape "
                         f"{tuple(shape)} and B {tuple(B.shape)} do not agree")


def cg_solve_batched(
    data: torch.Tensor,
    offsets,
    shape,
    B: torch.Tensor,
    X0: Optional[torch.Tensor] = None,
    policy: ConvergencePolicy = ConvergencePolicy(),
) -> CGResult:
    """Solve ``A_j x_j = b_j`` for k DIA systems of one sparsity by CG, the
    counterpart of ``jax.vmap(lambda d, b: cg_solve(DiaMatrix(d, offsets,
    shape), b, policy=policy))``.

    ``data`` is ``(k, ndiags, n)`` (member j's legs ``data[j]`` on
    ``offsets``), ``B`` and ``X0`` ``(k, n)``, all on one device.  Each
    iteration runs one batched kernel #4 launch with the fused p.Ap
    (``ops.cuda_dia.spmv_dot_dia_batched_cuda``, its twin on a CPU tensor;
    the initial residual takes one ``spmv_dia_batched_cuda``) and one host
    read; each member keeps its own scalars and its own count and freezes
    once it has converged, as the JAX ``while_loop`` under vmap does
    (``cg_block``).  Returns a ``CGResult`` whose fields carry the
    leading k axis: x ``(k, n)``; iterations (int32), residual and
    converged ``(k,)``."""
    check_batched(data, offsets, shape, B)
    offsets = tuple(int(o) for o in offsets)
    X0 = None if X0 is None else X0.to(B.dtype).expand_as(B).contiguous()
    X, it, res, converged = cg_block(lambda X: spmv_dia_batched_cuda(data, offsets, X),
                                     lambda P: spmv_dot_dia_batched_cuda(data, offsets, P),
                                     B, X0, policy)
    return CGResult(x=X, iterations=it, residual=res, converged=converged)
