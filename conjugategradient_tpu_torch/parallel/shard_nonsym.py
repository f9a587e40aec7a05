"""Row-block-sharded solvers beyond CG: BiCGStab, GMRES(m) and FGMRES,
IDR(s), MINRES, LSMR and the dot-free Chebyshev iteration.

The port of ``conjugategradient_tpu/parallel/shard_nonsym.py``, on the
single-controller mesh of ``parallel.mesh`` (a mesh may repeat a device:
four shards on one card).  Every vector is a ``parallel.mesh.Shards`` of
row blocks, every product kernel #4 once a shard (``parallel.halo.HaloDia``:
the shard's rows as a square DIA with zero halo rows; the all-gather window
where the band outreaches a shard), and the loops cross shards only by
``psum``/``pmax``/``ppermute``.  The single-device recurrences run on the
row blocks unchanged, their reductions handed in as collectives (the JAX
package's psum injection); each collective returns the replicated value
on the first shard's device.

- BiCGStab keeps the JAX package's two-collective iteration, not the
  single-device loop with its dots swapped: alpha's dot ``(rhat, v)``
  alone, then one fused (5,)-``psum`` of ``(t,s), (t,t), (s,s), (rhat,s),
  (rhat,t)``, from which omega, ``(r,r) = (s,s) - 2w(t,s) + w^2(t,t)``
  (clamped at 0: rounding can push it epsilon-negative at convergence) and
  the next rho ``(rhat,r) = (rhat,s) - w(rhat,t)`` follow algebraically.
- GMRES and FGMRES are ``solvers.gmres.gmres_loop``: each CGS2 pass one
  (k+1,)-``psum`` of the local Gram product (TF32 off, the JAX package's
  ``Precision.HIGHEST``), the basis ``(m+1, n_local)`` a shard, never
  gathered; FGMRES's Z shards like V, so a shard-local ``M`` may be
  nonlinear there.
- IDR(s) is ``solvers.idr.idr_loop``: the shadow drawn globally, its
  columns normalised over every row, each shard keeping its rows; each
  shadow product one (s,)-``psum``.
- MINRES (two scalar ``psum``s an iteration), LSMR (the two norms of the
  bidiagonalisation, A^T a second row-sharded DIA built once on the host)
  and Chebyshev (one ``psum`` per ``check_every`` products) are the
  single-device loops with their reductions injected.
- ``sharded_chebyshev_block_loop`` is the extended-region Chebyshev: the
  DIA legs extended once by the neighbours' ``H = check_every * halo``
  boundary rows (``halo.extend_dia_data``), then per block one fused
  ``ppermute`` pair of the (r, d) slabs and ``check_every`` products of
  kernel #4 on each shard's ``(ndiags, n_local + 2H)`` DIA, whose exact
  region shrinks by one bandwidth a product and still covers the shard's
  rows at the end (the matrix-powers argument of ``halo.dia_basis_powers``):
  2 ``ppermute`` + 1 ``psum`` a block instead of 2 ``ppermute`` a product.
  It makes the plain loop's iterates bit for bit.

Left out: the JAX factories' ``donate=`` and ``m_aux_spec`` (nothing is
compiled; a 2-D ``(n, bs)`` aux splits by rows as its ndim says) and the
factory cache, which eager PyTorch does not need.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, to_host, torch_dtype
from conjugategradient_tpu_torch.ops.cuda_dia import spmv_dia_cuda
from conjugategradient_tpu_torch.ops.precision import no_tf32
from conjugategradient_tpu_torch.parallel.halo import HaloDia, _square, extend_dia_data
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    make_mesh,
    pmax,
    ppermute,
    psum,
    shard_blocks,
    shard_rows,
)
from conjugategradient_tpu_torch.parallel.sharded_cg import (
    _ldot,
    _presidual,
    _sdiv,
    _shards,
    _unstack,
    sharded_cg_loop,
)
from conjugategradient_tpu_torch.solvers.cg import CGResult
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the bases of ``make_sharded_nonsym``
METHODS = ("bicgstab", "gmres", "fgmres", "minres", "chebyshev", "idr")


def _pdot_fused(pairs) -> Shards:
    """Several dots in one collective: each shard's partials stacked into a
    (k,) vector, one ``psum``."""
    return psum(Shards.map(lambda *uv: torch.stack([_ldot(uv[j], uv[j + 1])
                                                    for j in range(0, len(uv), 2)]),
                           *[t for pair in pairs for t in pair]))


def _dot(u: Shards, v: Shards) -> torch.Tensor:
    """Global u.v on the first shard's device: local dots, one ``psum``."""
    return psum(Shards.map(_ldot, u, v)).parts[0]


def _matdot(V: Shards, w: Shards) -> torch.Tensor:
    """Global ``V @ w`` for a shard's basis rows, TF32 off, one ``psum``."""
    with no_tf32():
        return psum(Shards.map(torch.matmul, V, w)).parts[0]


def _pmax_abs(r: Shards) -> torch.Tensor:
    return pmax(Shards.map(lambda t: t.abs().max(), r)).parts[0]


def sharded_bicgstab_loop(op, M, b: Shards, x0: Shards, policy: ConvergencePolicy,
                          n_global: int) -> CGResult:
    """The shard-local BiCGStab recurrence with the two-collective
    iteration (the module docstring): the single-device Krylov sequence in
    exact arithmetic.  ``M`` maps a row-sharded vector to one (``None``:
    the identity).  The host reads the residual once an iteration, from
    the first shard."""
    M = M or (lambda v: v)
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)

    x = x0
    r = b - op(x)
    rhat = r
    rr0, rho = _unstack(_pdot_fused(((r, r), (rhat, r))), 2)
    one = Shards.map(lambda t: torch.ones((), dtype=t.dtype, device=t.device), b)
    p = v = Shards.map(torch.zeros_like, b)
    rho_prev = alpha = omega = one
    rr = rr0
    it = 0
    # rho = (rhat, r) enters each iteration already reduced: by the init, or
    # by the previous iteration's fused (5,)-psum
    while it < max_iter and (it < min_iter or bool(_presidual(r, rr, rr0, policy.norm) >= tol)):
        beta = _sdiv(rho, rho_prev) * _sdiv(alpha, omega)
        p = r + beta * (p - omega * v)
        p_hat = M(p)
        v = op(p_hat)
        alpha = _sdiv(rho, psum(Shards.map(_ldot, rhat, v)))
        s = r - alpha * v
        s_hat = M(s)
        t = op(s_hat)
        ts, tt, ss, rhs, rht = _unstack(_pdot_fused(((t, s), (t, t), (s, s), (rhat, s),
                                                     (rhat, t))), 5)
        omega = _sdiv(ts, tt)
        x = x + alpha * p_hat + omega * s_hat
        r = s - omega * t
        # the algebraic (r, r), clamped: rounding can push the difference
        # epsilon-negative exactly at convergence
        rr = Shards.map(lambda a: torch.clamp_min(a, 0.0), ss - 2.0 * omega * ts + omega * omega * tt)
        rho_prev, rho = rho, rhs - omega * rht
        it += 1
    res = _presidual(r, rr, rr0, policy.norm)
    return CGResult(x=x, iterations=it, residual=res, converged=bool(res < tol) and it >= min_iter)


def _flat(op, M, shape):
    """``op`` and ``M`` over flat row blocks, for operators of grid blocks
    (``shape`` the local block's)."""
    if len(shape) <= 1:
        return op, M
    op_f = lambda u: op(u.reshape(shape)).reshape(-1)
    M_f = None if M is None else (lambda u: M(u.reshape(shape)).reshape(-1))
    return op_f, M_f


def sharded_gmres_loop(op, M, b: Shards, x0: Shards, policy: ConvergencePolicy, n_global: int,
                       restart: int = 32, flexible: bool = False):
    """``solvers.gmres.gmres_loop`` with ``psum``'d reductions (the module
    docstring); ``M=None`` for unpreconditioned.  ``flexible=True`` is
    row-sharded FGMRES: Z shards like V, and since the correction is
    assembled from Z locally a shard-local ``M`` may be nonlinear.  Grid
    blocks run flat (a row block of a grid's axis 0 is a row block of its
    flat vector); ``x`` comes back in ``b``'s shape."""
    from conjugategradient_tpu_torch.solvers.gmres import gmres_loop

    shape = tuple(b.shape)
    op_f, M_f = _flat(op, M, shape)
    res = gmres_loop(op_f, M_f, b.reshape(-1), x0.reshape(-1), policy, int(restart), dot=_dot,
                     matdot=_matdot, pmax_abs=_pmax_abs, n_global=n_global, flexible=flexible)
    return dataclasses.replace(res, x=res.x.reshape(shape))


def sharded_idr_loop(op, M, b: Shards, x0: Shards, policy: ConvergencePolicy, n_global: int,
                     s: int = 4, seed: int = 0, angle: float = 0.7, replace_every: int = 8,
                     shadow=None):
    """``solvers.idr.idr_loop`` with ``psum``'d reductions: each shadow
    product one (s,)-``psum``, the shadow the global ``(n_global, s)`` draw
    (``shadow``, or the port's seeded one) normalised over every row, each
    shard keeping its rows: the single-device trajectory up to the order of
    the partials.  ``iterations`` counts matvecs, ``s + 1`` a cycle."""
    from conjugategradient_tpu_torch.solvers.idr import idr_loop, shadow_space

    # the global draw, its columns normalised over every row, and each
    # shard's rows of it: the sharded iterates are the one-device ones up to
    # the order of the psum'd partials
    P = shadow_space(n_global, s, seed, b.dtype, b.device, shadow)
    mesh = b.mesh
    if mesh.ndim == 1:
        Pt = shard_rows(mesh, P)
    else:  # 2-D grid blocks: each shard's block of the shadow's grid, flat
        grid = tuple(n * k for n, k in zip(b.shape, mesh.dims)) + tuple(b.shape[mesh.ndim:])
        Pt = shard_blocks(mesh, P.reshape((s,) + grid), (1, 2)).reshape(s, -1)
    return idr_loop(op, M, b, x0, policy, s=s, seed=seed, angle=angle, dot=_dot, matdot=_matdot,
                    pmax_abs=_pmax_abs, n_global=n_global, replace_every=replace_every,
                    shadow_rows=Pt)


def sharded_minres_loop(op, M, b: Shards, x0: Shards, policy: ConvergencePolicy,
                        n_global: int) -> CGResult:
    """``solvers.minres.minres_loop`` with ``psum``'d reductions: the
    distributed symmetric-indefinite solver, two scalar ``psum``s an
    iteration (the Lanczos alfa and beta products)."""
    from conjugategradient_tpu_torch.solvers.minres import minres_loop

    return minres_loop(op, M, b, x0, policy, dot=_dot, pmax_abs=_pmax_abs, n_global=n_global)


def _pnorm(v: Shards) -> torch.Tensor:
    return torch.sqrt(_dot(v, v))


def sharded_lsmr_loop(op, opT, b: Shards, x0: Optional[Shards], policy: ConvergencePolicy,
                      n_global: int, damp: float = 0.0) -> CGResult:
    """``solvers.lsmr.lsmr_loop`` with a ``psum``'d 2-norm, the
    recurrence's only reduction: two scalar ``psum``s an iteration on top
    of the two products (A and A^T).  ``x0=None`` starts from zero without
    a product."""
    from conjugategradient_tpu_torch.solvers.lsmr import lsmr_loop

    b_eff = b if x0 is None else b - op(x0)
    x, it, res, converged, _ = lsmr_loop(op, opT, b_eff, policy, damp=damp,
                                         n_iter_scale=n_global, nrm=_pnorm)
    if x0 is not None:
        x = x + x0
    return CGResult(x=x, iterations=it, residual=res, converged=converged)


def sharded_chebyshev_loop(op, b: Shards, x0: Shards, policy: ConvergencePolicy, n_global: int,
                           lo: float, hi: float, check_every: int = 16) -> CGResult:
    """The dot-free distributed solve: one ``psum`` per ``check_every``
    halo-exchange products (``solvers.cheby.chebyshev_loop``)."""
    from conjugategradient_tpu_torch.solvers.cheby import chebyshev_loop

    return chebyshev_loop(op, b, x0, policy, lo, hi, _dot, check_every=check_every,
                          pmax_abs=_pmax_abs, n_global=n_global)


def _exchange2(r: Shards, d: Shards, H: int):
    """The block's one wire pair: both vectors' ``H``-row boundary slabs
    stacked into one message each way; returns the extended (r, d)."""
    lefts = ppermute(Shards.map(lambda a, c: torch.stack([a[-H:], c[-H:]]), r, d), 1)
    rights = ppermute(Shards.map(lambda a, c: torch.stack([a[:H], c[:H]]), r, d), -1)
    ext = lambda j: Shards.map(lambda l_, v, r_: torch.cat([l_[j], v, r_[j]]),
                               lefts, (r, d)[j], rights)
    return ext(0), ext(1)


def sharded_chebyshev_block_loop(data: Shards, offsets, b: Shards, x0: Shards,
                                 policy: ConvergencePolicy, n_global: int, lo: float, hi: float,
                                 check_every: int = 16) -> CGResult:
    """The extended-region Chebyshev (the module docstring): ``check_every``
    iterations per exchange, 2 ``ppermute`` + 1 ``psum`` a block, kernel #4
    on each shard's ``(ndiags, n_local + 2H)`` extended DIA.  ``data`` is
    the shards' ``(ndiags, n_local)`` legs; requires ``0 < check_every *
    halo <= n_local``.  The recurrence's coefficients are host scalars at
    the solve's dtype, as ``chebyshev_loop``'s, so the iterates are the
    plain loop's bit for bit."""
    offsets = tuple(offsets)
    n_local = b.shape[0]
    halo = max((abs(o) for o in offsets), default=0)
    check = int(check_every)
    H = check * halo
    if not 0 < H <= n_local:
        raise ValueError(f"the block loop needs 0 < check_every * halo ({H}) <= n_local "
                         f"({n_local})")
    dt = torch.empty(0, dtype=b.dtype).numpy().dtype.type
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)
    theta = dt((hi + lo) / 2.0)
    delta = dt((hi - lo) / 2.0)
    sigma = theta / delta
    one, two = dt(1.0), dt(2.0)

    mats = Shards.map(lambda d: _square(d, offsets), extend_dia_data(data, H))
    r = b - HaloDia(data, offsets, halo, False)(x0)
    rr0 = psum(Shards.map(_ldot, r, r))
    rr = rr0
    linf = policy.norm == "linf"
    x, d = x0, Shards.map(torch.zeros_like, b)
    rho_prev = dt(0.0)
    it, started = 0, False
    while it < max_iter and (it < min_iter or bool(_presidual(r, rr, rr0, policy.norm) >= tol)):
        r_e, d_e = _exchange2(r, d, H)
        for _ in range(check):
            if it >= max_iter:
                break  # the JAX package's masked steps past the cap: no-ops
            if started:
                rho = one / (two * sigma - rho_prev)
                d_e = float(rho * rho_prev) * d_e + float(two * rho / delta) * r_e
            else:
                rho = one / sigma
                d_e = r_e / float(theta)
            x = x + Shards.map(lambda t: t[H:H + n_local], d_e)
            r_e = r_e - Shards.map(spmv_dia_cuda, mats, d_e)
            rho_prev, started, it = rho, True, it + 1
        r = Shards.map(lambda t: t[H:H + n_local], r_e)
        d = Shards.map(lambda t: t[H:H + n_local], d_e)
        if not linf:
            rr = psum(Shards.map(_ldot, r, r))
    res = _presidual(r, rr, rr0, policy.norm)
    return CGResult(x=x, iterations=it, residual=res, converged=bool(res < tol) and it >= min_iter)


def run_sharded_loop(method: str, op, M, b: Shards, x0: Shards, policy: ConvergencePolicy,
                     n_global: int, restart: int = 32, s: int = 4, seed: int = 0,
                     angle: float = 0.7, replace_every: int = 8, shadow=None):
    """The sharded recurrence of ``method`` (``cg``, ``bicgstab``,
    ``gmres``, ``fgmres``, ``minres``, ``idr``) over ``op`` and ``M`` (a
    map of row-sharded vectors, ``None``: none): what
    ``make_sharded_nonsym``, the sharded V-cycle's carrier
    (``parallel.gspmd.make_gspmd_mg_nonsym``) and ``parallel.shard_amg``
    run."""
    if method == "cg":
        return sharded_cg_loop(op, M or (lambda v: v), b, x0, policy, n_global)
    if method == "bicgstab":
        return sharded_bicgstab_loop(op, M, b, x0, policy, n_global)
    if method == "idr":
        return sharded_idr_loop(op, M, b, x0, policy, n_global, s=s, seed=seed, angle=angle,
                                replace_every=replace_every, shadow=shadow)
    if method == "minres":
        return sharded_minres_loop(op, M, b, x0, policy, n_global)
    if method in ("gmres", "fgmres"):
        return sharded_gmres_loop(op, M, b, x0, policy, n_global, restart=restart,
                                  flexible=method == "fgmres")
    raise ValueError(f"unknown method {method!r}")


def make_sharded_nonsym(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    axis: str = "x",
    M_local: Optional[Callable] = None,
    restart: int = 32,
    bounds=None,
    check_every: int = 16,
    s: int = 4,
    seed: int = 0,
    angle: float = 0.7,
    replace_every: int = 8,
    shadow=None,
):
    """Build a row-block-sharded solver for A's sparsity (DIA, kernel #4 a
    shard: one-hop halos, the all-gather window where the bandwidth
    exceeds a shard's rows; ``make_sharded_cg``'s operator).

    Returns ``solve(data, b, x0[, m_aux]) -> CGResult`` with ``x`` the
    global solution on the mesh's first device; each argument a ``Shards``
    of this mesh or a global array (split here; a 2-D ``m_aux`` by rows).
    ``M_local(r_local, m_aux_local)`` is a shard-local right
    preconditioner, linear except under ``fgmres``, where it may be
    nonlinear (a fixed-budget inner solve on the shard's diagonal block).
    ``method="chebyshev"`` (dot-free; ``bounds=(lo, hi)`` required) ignores
    ``M_local`` and takes the extended-region block loop wherever ``0 <
    check_every * halo <= n_local`` on the halo route.  ``idr`` takes
    ``s``, ``seed``, ``angle``, ``replace_every`` and ``shadow`` (the
    global ``(n, s)`` draw).  ``solve.route`` is ``"halo"``,
    ``"all-gather"`` or ``"chebyshev block"``."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}; want {'|'.join(METHODS)}")
    if not isinstance(A, DiaMatrix):
        raise TypeError(f"the sharded nonsymmetric solvers take a DiaMatrix, got {type(A).__name__}")
    if method == "chebyshev" and bounds is None:
        raise ValueError("chebyshev requires bounds=(lo, hi)")
    mesh.one_process("make_sharded_nonsym")
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    n_local = n // num
    halo = A.bandwidth
    offsets = tuple(A.offsets)
    use_allgather = halo > n_local
    block = (method == "chebyshev" and not use_allgather
             and 0 < int(check_every) * halo <= n_local)

    def solve(data, b, x0, m_aux=None) -> CGResult:
        b = _shards(mesh, b, None)
        x0 = _shards(mesh, x0, b.dtype)
        data = _shards(mesh, data, None)
        if method == "chebyshev":
            lo, hi = (float(v) for v in bounds)
            if block:
                res = sharded_chebyshev_block_loop(data, offsets, b, x0, policy, n, lo, hi,
                                                   check_every)
            else:
                res = sharded_chebyshev_loop(HaloDia(data, offsets, halo, use_allgather), b, x0,
                                             policy, n, lo, hi, check_every)
        else:
            M = None
            if M_local is not None:
                aux = _shards(mesh, m_aux, b.dtype, dim=0)
                M = lambda r: Shards.map(M_local, r, aux)
            res = run_sharded_loop(method, HaloDia(data, offsets, halo, use_allgather), M, b, x0,
                                   policy, n, restart=restart, s=s, seed=seed, angle=angle,
                                   replace_every=replace_every, shadow=shadow)
        return dataclasses.replace(res, x=res.x.gather())

    solve.route = "chebyshev block" if block else ("all-gather" if use_allgather else "halo")
    return solve


def make_sharded_lsmr(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    damp: float = 0.0,
):
    """Build a row-block-sharded LSMR solver for a square-banded DIA.

    Least squares needs A and A^T products: the transpose is built once on
    the host (offsets negated, columns rolled: ``core.formats.transpose``)
    and runs as a second row-sharded DIA on kernel #4.  A rectangular
    system reaches this square-padded (zero rows and columns are neutral
    in LSMR).  Returns ``(solve, A_t)``; ``solve(data, dataT, b, x0=None)``
    with both DIA data arrays as ``Shards`` or global arrays."""
    from conjugategradient_tpu_torch.core.formats import transpose

    mesh.one_process("make_sharded_lsmr")
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    n_local = n // num
    halo = A.bandwidth
    use_allgather = halo > n_local
    A_t = transpose(to_host(A))
    offsets, offsets_t = tuple(A.offsets), tuple(A_t.offsets)

    def solve(data, dataT, b, x0=None) -> CGResult:
        b = _shards(mesh, b, None)
        x0 = None if x0 is None else _shards(mesh, x0, b.dtype)
        op = HaloDia(_shards(mesh, data, None), offsets, halo, use_allgather)
        opT = HaloDia(_shards(mesh, dataT, None), offsets_t, halo, use_allgather)
        res = sharded_lsmr_loop(op, opT, b, x0, policy, n, damp=damp)
        return dataclasses.replace(res, x=res.x.gather())

    solve.route = "all-gather" if use_allgather else "halo"
    return solve, A_t


def sharded_lsmr_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    damp: float = 0.0,
    dtype=None,
) -> CGResult:
    """One-call convenience: split the square-banded system over the mesh
    (every visible CUDA device by default) and LSMR-solve ``min ||A x -
    b|| (+ damp^2 ||x||^2)`` in ``dtype`` (default ``A.data``'s)."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    dt = torch_dtype(dtype if dtype is not None else A.data.dtype)
    solve, A_t = make_sharded_lsmr(A, mesh, policy, axis=axis, damp=damp)
    x0_sh = None if x0 is None else _shards(mesh, x0, dt)
    return solve(_shards(mesh, A.data, dt), _shards(mesh, A_t.data, dt), _shards(mesh, b, dt),
                 x0_sh)


def sharded_nonsym_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    method: str = "bicgstab",
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    restart: int = 32,
    bounds=None,
    check_every: int = 16,
    dtype=None,
    s: int = 4,
    seed: int = 0,
    angle: float = 0.7,
    replace_every: int = 8,
    shadow=None,
) -> CGResult:
    """One-call convenience: split the system over the mesh (every visible
    CUDA device by default) and solve in ``dtype`` (default ``A.data``'s).
    For a preconditioned solve pass ``M_local`` and the global ``M_aux``
    (``(n,)``, or ``(n, bs)`` for block Jacobi)."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    dt = torch_dtype(dtype if dtype is not None else A.data.dtype)
    solve = make_sharded_nonsym(A, mesh, policy, method=method, axis=axis, M_local=M_local,
                                restart=restart, bounds=bounds, check_every=check_every, s=s,
                                seed=seed, angle=angle, replace_every=replace_every,
                                shadow=shadow)
    b_sh = _shards(mesh, b, dt)
    x0_sh = Shards.map(torch.zeros_like, b_sh) if x0 is None else _shards(mesh, x0, dt)
    aux = None if M_local is None else _shards(mesh, M_aux, dt, dim=0)
    return solve(_shards(mesh, A.data, dt), b_sh, x0_sh, aux)
