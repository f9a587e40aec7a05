"""Row-block-sharded CG over a device mesh: the reference's multi-GPU solver.

The port of ``conjugategradient_tpu/parallel/sharded_cg.py``, itself the
redesign of ``Mgcg/cuBlas/Mgcg/ConjugateGradientParallelGpu.cs:11-596``,
whose iteration stages the halo through the host (``SyncP``), fans out the
SpMV and partial p.Ap, sums the partials on the host, fans out the x, r
update and partial r.r, sums again, checks convergence and fans out the
direction update.

The JAX package runs the whole loop as one SPMD program under
``shard_map``.  The port drives the shards from one process, as the JAX
package's single controller and the reference's ``Parallel.For`` do: every
vector is a ``parallel.mesh.Shards`` (one row block per mesh position),
arithmetic runs shard by shard on each shard's device, and the loops reach
other shards only through the collectives of ``parallel.mesh`` (``psum``,
``pmax``, ``ppermute``, ``all_gather``) and the halo products of
``parallel.halo``.

- A ``psum`` adds the shards' partials in shard order on the first shard's
  device, in the working dtype, and copies the sum to every shard's device;
  ``cg1`` and ``pipelined`` stack their three partials into one ``psum``
  (``_pdot_fused``).
- Each shard's local SpMV is kernel #4 (``parallel.halo.HaloDia``: the
  shard's rows as a square DIA with zero halo rows, one launch a shard per
  product); ``variant="cg"`` takes the fused form, whose dot is the shard's
  p.Ap, and writes each new direction into the halo-padded buffer the next
  product reads (no copy of p).  On a CPU tensor the kernel's twin runs.
- As in ``solvers.cg.cg_solve``, the host reads one value per iteration:
  the psum'd residual of the convergence predicate, from the first shard.

A mesh may repeat a device (four shards on one card measure what sharding
costs, not multi-GPU speed); on a host with several cards the same code
spans them.

Left out: the JAX factories' ``donate=`` (buffer donation to a jitted
program; nothing here is compiled, so nothing is donated).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix, torch_dtype
from conjugategradient_tpu_torch.ops.blas import residual_norm
from conjugategradient_tpu_torch.parallel.halo import HaloDia, dia_basis_powers, extend_dia_data
from conjugategradient_tpu_torch.parallel.mesh import (
    Mesh,
    Shards,
    make_mesh,
    pmax,
    psum,
    replicate,
    shard_rows,
)
from conjugategradient_tpu_torch.solvers.cacg import gram64
from conjugategradient_tpu_torch.solvers.cg import CGResult, _safe_div
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


def _ldot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _pdot(a: Shards, b: Shards) -> Shards:
    """Global a.b, replicated: local dots, one ``psum``."""
    return psum(Shards.map(_ldot, a, b))


def _pdot_fused(pairs) -> Shards:
    """Several dots in one collective: each shard's partials stacked into a
    (k,) vector and psum'd together."""
    return psum(Shards.map(lambda *uv: torch.stack([_ldot(uv[j], uv[j + 1])
                                                    for j in range(0, len(uv), 2)]),
                           *[t for pair in pairs for t in pair]))


def _unstack(v: Shards, k: int):
    return [Shards.map(lambda t, j=j: t[j], v) for j in range(k)]


def _sdiv(a: Shards, b: Shards) -> Shards:
    return Shards.map(_safe_div, a, b)


def _presidual(r: Shards, rr: Shards, rr0: Shards, norm: str) -> torch.Tensor:
    """The residual in ``norm`` as the first shard holds it (a 0-d tensor on
    its device): from the psum'd r.r, or one ``pmax`` for ``linf``."""
    if norm == "linf":
        return pmax(Shards.map(lambda t: t.abs().max(), r)).parts[0]
    return residual_norm(None, rr.parts[0], rr0.parts[0], norm)


def _stack_basis(op, s: int):
    """The CA-CG basis ``[p, Ap, ..., A^s p, r, ..., A^{s-1} r]`` by 2s-1
    products, stacked on each shard."""

    def build(p, r):
        rows = []
        for v, k in ((p, s), (r, s - 1)):
            rows.append(v)
            for _ in range(k):
                v = op(v)
                rows.append(v)
        return Shards.map(lambda *vs: torch.stack([t.reshape(-1) for t in vs]), *rows)

    return build


def sharded_cg_loop(
    op,
    M,
    b: Shards,
    x0: Shards,
    policy: ConvergencePolicy,
    n_global: int,
    variant: str = "cg",
    project=None,
    project_r=None,
    s: int = 4,
    cacg_basis=None,
) -> CGResult:
    """The sharded CG recurrence, format-agnostic: ``op`` and ``M`` map a
    row-sharded vector to one (with whatever collectives they need inside),
    dots are ``psum``'d.  Shared by the DIA solver below and the CSR/ELL
    solver of ``parallel.sharded_general``.  Returns a ``CGResult`` whose
    ``x`` is the ``Shards`` of the solution.

    ``project``/``project_r`` are the deflation hooks (a
    ``Deflation.with_axis(axis)`` over row-sharded W and AW carries its own
    psum), as in the single-device step; only ``variant="cg"`` takes them.

    ``variant`` selects the communication structure (the same Krylov
    sequence in exact arithmetic):

    - ``"cg"``: the textbook recurrence, two reductions an iteration (p.Ap,
      then r.z and r.r); on a ``HaloDia`` the p.Ap partials come from the
      fused kernel, and each direction is written into the buffer the next
      product reads.
    - ``"cg1"``: Chronopoulos-Gear single-reduce CG, one fused (3,)-psum an
      iteration at two more vector recurrences.
    - ``"pipelined"``: Ghysels-Vanroose, the SpMV independent of the
      reduction of the same iteration; the predicate lags one update and
      the final residual is recomputed.
    - ``"cacg"``: s-step CG (``solvers.cacg.cacg_loop``): one psum'd fp64
      Gram and one residual-replacement dot per s iterations;
      unpreconditioned, ``l2``/``rel_l2`` only.  ``cacg_basis`` replaces
      the 2s-1 products of the basis (the matrix-powers kernel).
    """
    if variant == "cacg":
        if project is not None or project_r is not None:
            raise ValueError("deflation hooks require variant='cg'")
        from conjugategradient_tpu_torch.solvers.cacg import cacg_loop

        return cacg_loop(op, b, x0, policy, int(s), dot=lambda u, v: _pdot(u, v).parts[0],
                         gram=lambda V: psum(Shards.map(gram64, V)).parts[0],
                         n_global=n_global, basis=cacg_basis or _stack_basis(op, int(s)))
    if variant in ("cg1", "pipelined"):
        if project is not None or project_r is not None:
            raise ValueError(
                "deflation hooks require variant='cg' (the communication-reduced recurrences "
                "carry derived state the projections would desynchronise)")
        return _cg1_loop(op, M, b, x0, policy, n_global, pipelined=variant == "pipelined")
    if variant != "cg":
        raise ValueError(f"unknown CG variant {variant!r}; want cg|cg1|pipelined|cacg")
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)
    spmv_dot = getattr(op, "spmv_dot", None)
    fresh = getattr(op, "fresh", None)

    def product(p):
        if spmv_dot is None:
            Ap = op(p)
            return Ap, _pdot(p, Ap)
        Ap, part = spmv_dot(p)
        return Ap, psum(part)

    def direction(z, beta, p):
        if fresh is None:
            return z + beta * p
        out = fresh(p)  # the buffer the next product reads
        for o, p_, b_, z_ in zip(out.parts, p.parts, beta.parts, z.parts):
            torch.mul(p_, b_, out=o).add_(z_)
        return out

    x = x0
    r = b - op(x)
    if project_r is not None:
        r = project_r(r)
    z = M(r)
    p = z if project is None else project(z)
    rz = _pdot(r, z)
    rr = _pdot(r, r)
    rr0 = rr
    it = 0
    while it < max_iter and (it < min_iter or bool(_presidual(r, rr, rr0, policy.norm) >= tol)):
        Ap, pAp = product(p)
        alpha = _sdiv(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        if project_r is not None:
            r = project_r(r)
        z = M(r)
        rz_new = _pdot(r, z)
        rr = _pdot(r, r)
        beta = _sdiv(rz_new, rz)
        p = direction(z if project is None else project(z), beta, p)
        rz = rz_new
        it += 1
    res = _presidual(r, rr, rr0, policy.norm)
    return CGResult(x=x, iterations=it, residual=res, converged=bool(res < tol) and it >= min_iter)


def _cg1_loop(op, M, b, x0, policy, n_global, pipelined: bool) -> CGResult:
    """Chronopoulos-Gear single-reduce CG, or Ghysels-Vanroose pipelined
    with ``pipelined``: the JAX package's ``_cg1_loop``, u = M r and w = A u
    carried so that gamma = (r, u), delta = (w, u) and (r, r) ship as one
    fused (3,)-psum.  ``pipelined`` advances u and w by recurrences and
    computes m = M w, n = A m beside the reduction of the same iteration;
    its predicate lags one update, and its final r.r is recomputed."""
    tol = torch.tensor(policy.tol, dtype=b.dtype, device=b.device)
    min_iter = policy.min_iteration
    max_iter = policy.resolve_max(n_global)
    norm = policy.norm

    def scalars(gamma, delta, gamma_prev, alpha_prev):
        # beta = 0 on the first trip (gamma_prev = 0), which makes alpha
        # gamma/delta, plain CG's first step
        beta = _sdiv(gamma, gamma_prev)
        alpha = _sdiv(gamma, delta - _sdiv(beta * gamma, alpha_prev))
        return alpha, beta

    def go(r, rr, it):
        return it < max_iter and (it < min_iter or bool(_presidual(r, rr, rr0, norm) >= tol))

    x = x0
    r = b - op(x)
    u = M(r)
    w = op(u)
    gamma, delta, rr = _unstack(_pdot_fused(((r, u), (w, u), (r, r))), 3)
    rr0 = rr
    zerov = Shards.map(torch.zeros_like, b)
    zero = Shards.map(lambda t: torch.zeros((), dtype=t.dtype, device=t.device), b)
    p = s = zerov
    g_prev = a_prev = zero
    it = 0
    if not pipelined:
        # (gamma, delta, rr) always describe the current (r, u, w)
        while go(r, rr, it):
            alpha, beta = scalars(gamma, delta, g_prev, a_prev)
            p = u + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            u = M(r)
            w = op(u)
            g_prev, a_prev = gamma, alpha
            gamma, delta, rr = _unstack(_pdot_fused(((r, u), (w, u), (r, r))), 3)
            it += 1
    else:
        # the dots of the state's (r, u, w) sit beside m = M w, n = A m: the
        # carried rr describes the previous body's r
        q = z = zerov
        while go(r, rr, it):
            gamma, delta, rr = _unstack(_pdot_fused(((r, u), (w, u), (r, r))), 3)
            m = M(w)
            n = op(m)  # no data dependence on the reduction above
            alpha, beta = scalars(gamma, delta, g_prev, a_prev)
            z = n + beta * z
            q = m + beta * q
            p = u + beta * p
            s = w + beta * s
            x = x + alpha * p
            r = r - alpha * s
            u = u - alpha * q
            w = w - alpha * z
            g_prev, a_prev = gamma, alpha
            it += 1
        rr = _pdot(r, r)  # fresh: the carried rr lags one update
    res = _presidual(r, rr, rr0, norm)
    return CGResult(x=x, iterations=it, residual=res, converged=bool(res < tol) and it >= min_iter)


def _shards(mesh: Mesh, a, dtype, dim: int = -1) -> Shards:
    """``a`` (a global array, or ``Shards`` of this mesh) as ``Shards`` of
    ``dtype`` (``None``: kept)."""
    if isinstance(a, Shards):
        if a.mesh.layout != mesh.layout:
            raise ValueError(f"Shards of {a.mesh} on a solve over {mesh}")
        return a if dtype is None else Shards.map(lambda t: t.to(torch_dtype(dtype)), a)
    return shard_rows(mesh, a, dtype, dim=dim)


def shard_deflation(deflation, mesh: Mesh, dtype=None):
    """A ``solvers.deflation.Deflation`` built on the full system, with W
    and AW split into the mesh's row blocks and the k x k factor and scale
    on every shard's device: what a sharded def-CG takes."""
    dt = torch_dtype(dtype) if dtype is not None else deflation.W.dtype
    return dataclasses.replace(
        deflation, W=_shards(mesh, deflation.W, dt, dim=0),
        AW=_shards(mesh, deflation.AW, dt, dim=0),
        chol_E=replicate(mesh, deflation.chol_E, dt), scale=replicate(mesh, deflation.scale, dt))


def make_sharded_cg(
    A: DiaMatrix,
    mesh: Mesh,
    policy: ConvergencePolicy = ConvergencePolicy(),
    axis: str = "x",
    M_local: Optional[Callable] = None,
    variant: str = "cg",
    deflation=None,
    s: int = 4,
):
    """Build a sharded solver for A's sparsity.

    Returns ``solve(data, b, x0) -> CGResult``, or with ``M_local``
    ``solve(data, b, x0, m_aux)`` (``M_local(r_local, m_aux_local)``
    applies the preconditioner to one shard's rows: pointwise or otherwise
    row-local), and with ``deflation`` one more argument, the same
    ``Deflation`` (built on the full system; ``shard_deflation`` splits
    it).  Each argument may be a ``Shards`` of this mesh or a global array
    (split here); the solve runs in b's dtype.  ``x`` of the result is the
    global solution on the mesh's first device; on a mesh that spans
    processes, the ``Shards`` of this process's blocks of it (what the JAX
    factory's global array holds on each host).

    ``A`` gives the structure only (offsets, shape); its ``data`` is the
    solve's argument, as in the JAX package.  Requires
    ``A.n % num_shards == 0``
    (``core.partition.pad_system``).  Where the bandwidth fits a shard the
    product takes one-hop halos, else the all-gather form
    (``parallel.halo.HaloDia``); general CSR/ELL sparsity is
    ``parallel.sharded_general``'s."""
    num = mesh.shape[axis]
    n = A.n
    if n % num:
        raise ValueError(f"n={n} not divisible by {num} shards; pad_system first")
    if variant == "cacg" and (M_local is not None or deflation is not None):
        raise ValueError(
            "variant='cacg' is unpreconditioned (fold diagonal scaling into A) and takes no "
            "deflation; use variant='cg' for those")
    n_local = n // num
    halo = A.bandwidth
    offsets = tuple(A.offsets)
    use_allgather = halo > n_local

    def solve(data, b, x0, *extra):
        b = _shards(mesh, b, None)
        x0 = _shards(mesh, x0, b.dtype)
        data = _shards(mesh, data, None)
        op = HaloDia(data, offsets, halo, use_allgather)
        extra = list(extra)
        m_aux = _shards(mesh, extra.pop(0), b.dtype) if M_local is not None else None
        defl = extra.pop(0) if deflation is not None else None
        M = (lambda r: Shards.map(M_local, r, m_aux)) if M_local is not None else (lambda r: r)
        basis = None
        if variant == "cacg" and not use_allgather and 0 < s * halo <= n_local:
            # the matrix-powers kernel: the neighbours' boundary rows once
            # per solve, then one widened exchange per outer step
            data_ext = extend_dia_data(data, s * halo)
            basis = lambda p_, r_: dia_basis_powers(data_ext, offsets, p_, r_, s, halo)
        if defl is None:
            res = sharded_cg_loop(op, M, b, x0, policy, n, variant=variant, s=s,
                                  cacg_basis=basis)
        else:
            if not isinstance(defl.W, Shards):
                defl = shard_deflation(defl, mesh, b.dtype)
            d = defl.with_axis(axis)
            res = sharded_cg_loop(op, M, b, d.galerkin_correct(x0, b - op(x0)), policy, n,
                                  variant=variant, project=d.project_direction,
                                  project_r=d.project_residual)
            # the final Galerkin correction restores the span{W} components
            # that project_r kept out of the recurrence
            res = dataclasses.replace(res, x=d.galerkin_correct(res.x, b - op(res.x)))
        return res if mesh.comm is not None else dataclasses.replace(res, x=res.x.gather())

    return solve


def sharded_cg_solve(
    A: DiaMatrix,
    b,
    x0=None,
    policy: ConvergencePolicy = ConvergencePolicy(),
    mesh: Optional[Mesh] = None,
    axis: str = "x",
    M_local: Optional[Callable] = None,
    M_aux=None,
    dtype=None,
    variant: str = "cg",
    deflation=None,
    s: int = 4,
) -> CGResult:
    """One-call convenience: split the system over the mesh (every visible
    CUDA device by default) and solve.  ``A.data``, ``b``, ``x0`` and
    ``M_aux`` may be host arrays, tensors or ``Shards``; ``dtype`` (default
    ``A.data``'s) is the solve's.  For a preconditioned solve pass both
    ``M_local`` and the global (n,) ``M_aux``; ``deflation`` (from
    ``make_deflation`` on the full system) runs distributed def-CG."""
    if mesh is None:
        mesh = make_mesh(axis=axis)
    dt = torch_dtype(dtype if dtype is not None else A.data.dtype)
    solve = make_sharded_cg(A, mesh, policy, axis=axis, M_local=M_local,
                            variant=variant, deflation=deflation, s=s)
    b_sh = _shards(mesh, b, dt)
    x0_sh = Shards.map(torch.zeros_like, b_sh) if x0 is None else _shards(mesh, x0, dt)
    args = [_shards(mesh, A.data, dt), b_sh, x0_sh]
    if M_local is not None:
        args.append(_shards(mesh, M_aux, dt))
    if deflation is not None:
        args.append(shard_deflation(deflation, mesh, dt))
    return solve(*args)
