"""Geometric multigrid: hierarchy setup, V-cycle and the MGCG preconditioner.

The slice of ``conjugategradient_tpu/precond/multigrid.py`` that the MGCG
paths run: grid-shaped (stencil) levels with full-weighting transfers, coarse
operators by the Galerkin product ``R A P`` (the default) or by a
rediscretization hook (``coarse_operator``), and a dense inverse on the
coarsest grid.  Setup is host-side numpy and scipy; the hierarchy is an
``nn.Module`` whose per-level ``inv_diag``, variable-coefficient ``legs`` and
``coarse_inv`` are registered buffers, so ``.to(device)`` moves it.

A level whose operator is constant over the grid (the Poisson ladder)
const-detects to a ``ConstStencilMatrix`` with a scalar ``inv_diag`` and
Gershgorin Chebyshev bounds; any other level keeps its legs (a
``StencilMatrix`` over the ``legs`` buffer, kernel #3 on the card), a
grid-shaped ``inv_diag`` and bounds from the host power iteration.  On a 3-D
const level with fp32 state the Chebyshev smoothing runs fused
(``ops.cuda_stencil.cheb_smooth_const_cuda``); every other level, and every
fp64 run, takes the unfused ``chebyshev_smooth`` built from the SpMV kernel.
"""

from __future__ import annotations

import time
from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
    dia_diagonal,
    dia_to_dense,
    default_device,
    dia_to_stencil,
    place,
    stencil_to_const,
)
from conjugategradient_tpu_torch.ops.cuda_stencil import cheb_smooth_const_cuda
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.precond import transfer
from conjugategradient_tpu_torch.precond.smoothers import chebyshev_smooth, jacobi_smooth
from conjugategradient_tpu_torch.solvers import eigen

GridShape = Tuple[int, ...]

_REST_OF_HIERARCHY = "ROADMAP queue 1 item 9 (the rest of the hierarchy)"
#: semicoarsening threshold: an axis whose coupling is below this share of
#: the strongest one is not coarsened (the JAX package's default)
_SEMI_THETA = 0.25


class MgLevel(nn.Module):
    """One level: operator, ``1/diag`` buffer (a scalar on a const level,
    grid-shaped on a variable one), grid geometry, Chebyshev bounds of
    D^{-1}A and the transfer kind.

    A variable level registers its legs as the buffer ``legs`` and builds
    ``A`` over that buffer on every access, so ``.to(device)`` (or a dtype
    cast) moves the operator with the level."""

    def __init__(self, A, inv_diag: torch.Tensor, grid: GridShape,
                 cheb_bounds: Tuple[float, float], transfer: str = "fw"):
        super().__init__()
        if isinstance(A, StencilMatrix):
            self._const = None
            self.shifts = tuple(A.shifts)
            legs = A.data if torch.is_tensor(A.data) else torch.from_numpy(np.asarray(A.data))
            self.register_buffer("legs", legs.contiguous())
        else:
            self._const = A
        self.register_buffer("inv_diag", inv_diag)
        self.grid = tuple(grid)
        self.cheb_bounds = tuple(cheb_bounds)
        self.transfer = transfer

    @property
    def A(self):
        """The level's operator: the ``ConstStencilMatrix``, or a
        ``StencilMatrix`` over the current ``legs`` buffer."""
        if self._const is not None:
            return self._const
        return StencilMatrix(self.legs, self.shifts, self.grid)


class MgHierarchy(nn.Module):
    """Static hierarchy: ``levels[0]`` is the fine grid; the coarsest grid is
    solved with the dense inverse ``coarse_inv``.  ``setup_s`` holds
    ``build_hierarchy``'s host-clock seconds by phase (empty otherwise)."""

    def __init__(self, levels, coarse_inv: torch.Tensor, smoother: str, pre: int,
                 post: int, omega: float):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.smoother = smoother
        self.pre = pre
        self.post = post
        self.omega = omega
        self.setup_s = {}

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1  # + coarsest direct level


def _dia_to_scipy(A: DiaMatrix) -> sp.csr_matrix:
    """Direct DIA -> scipy.dia -> csr.  Our data is row-indexed
    (``data[k, i] = A[i, i+off]``), scipy's column-indexed
    (``data[k, j] = A[j-off, j]``): shift by off."""
    n = A.n
    data = np.asarray(A.data)
    sdata = np.zeros_like(data)
    for k, off in enumerate(A.offsets):
        if off >= 0:
            sdata[k, off:] = data[k, : n - off]
        elif off < 0:
            sdata[k, : n + off] = data[k, -off:]
    return sp.dia_matrix((sdata, np.asarray(A.offsets)), shape=(n, n)).tocsr()


def _scipy_to_dia(S: sp.spmatrix) -> DiaMatrix:
    """scipy -> DIA via scipy's own ``.todia()``, un-shifting the
    column-indexed layout back to row-indexed, offsets ascending."""
    D = S.todia()
    n = D.shape[0]
    offsets = tuple(int(o) for o in D.offsets)
    order = np.argsort(offsets)
    sdata = np.asarray(D.data)
    out = np.zeros((len(offsets), n), dtype=sdata.dtype)
    for slot, k in enumerate(order):
        off = offsets[k]
        if off >= 0:
            out[slot, : n - off] = sdata[k, off:]
        else:
            out[slot, -off:] = sdata[k, : n + off]
    return DiaMatrix(out, tuple(offsets[k] for k in order), (n, n))


def _const_near_null(A_h: DiaMatrix, grid: GridShape) -> bool:
    """True iff the constant (not the checkerboard) is the near-null
    candidate, the precondition for geometric transfers: the two Rayleigh
    numerators ones.A.ones and alt.A.alt by the host oracle."""
    ones = np.ones(A_h.n)
    alt = np.where(np.indices(grid).sum(axis=0).reshape(-1) % 2 == 0, 1.0, -1.0)
    q1 = float(ones @ oracle.spmv(A_h, ones))
    q2 = float(alt @ oracle.spmv(A_h, alt))
    return q1 <= q2


def _axis_strengths(st: StencilMatrix) -> np.ndarray:
    """Per-axis coupling strength: max |value| over the axis-aligned
    off-diagonal stencil legs (the semicoarsening detector)."""
    d = st.ndim
    out = np.zeros(d)
    data = np.asarray(st.data)
    for k, shift in enumerate(st.shifts):
        nz = [ax for ax in range(d) if shift[ax] != 0]
        if len(nz) == 1:
            out[nz[0]] = max(out[nz[0]], float(np.max(np.abs(data[k]))))
    return out


def _const_axis_strengths(Ac: ConstStencilMatrix, g: GridShape) -> np.ndarray:
    """``_axis_strengths`` of a const stencil, from its coefficients."""
    s_ax = np.zeros(len(g))
    for c, s in zip(Ac.coeffs, Ac.shifts):
        nz = [ax for ax in range(len(g)) if s[ax] != 0]
        if len(nz) == 1:
            s_ax[nz[0]] = max(s_ax[nz[0]], abs(float(c)))
    return s_ax


def _const_bounds(Ac: ConstStencilMatrix, lower_frac: float = 0.25):
    """Chebyshev smoothing interval of a const stencil by Gershgorin on
    D^{-1}A: lam_max = 1 + sum|c_off| / c_center (exactly 2.0 for the
    Dirichlet Laplacians), lam_min = lower_frac * lam_max."""
    c0 = None
    rad = 0.0
    for c, s in zip(Ac.coeffs, Ac.shifts):
        if all(d == 0 for d in s):
            c0 = float(c)
        else:
            rad += abs(float(c))
    if c0 is None or c0 <= 0:
        raise ValueError("const stencil lacks a positive center coefficient")
    lam_max = 1.0 + rad / c0
    return lower_frac * lam_max, lam_max


def _geometric_ok(Ac: ConstStencilMatrix, g: GridShape) -> bool:
    """``_const_near_null`` of a const stencil in closed form: each leg
    counts once per valid position, times (-1)^{sum s} when alternating."""

    def _q(signed: bool) -> float:
        tot = 0.0
        for c, sh in zip(Ac.coeffs, Ac.shifts):
            cnt = 1.0
            for ax, d in enumerate(sh):
                cnt *= max(0, g[ax] - abs(d))
            sgn = (-1.0) ** sum(sh) if signed else 1.0
            tot += float(c) * sgn * cnt
        return tot

    return _q(False) <= _q(True)


def _hybrid_applies(g: GridShape) -> bool:
    """Whether the JAX package's auto choice would take hybrid fw/cell-
    centered transfers: every odd axis >= 3, every even axis >= 2, and every
    resulting coarse axis >= 5."""
    coarse = []
    for n in g:
        if n % 2 == 1 and n >= 3:
            coarse.append((n - 1) // 2)
        elif n % 2 == 0 and n >= 2:
            coarse.append(n // 2)
        else:
            return False
    return all(n >= 5 for n in coarse)


def _pick_kind(g: GridShape, geom_ok: bool) -> Optional[str]:
    """The JAX package's auto transfer choice: full weighting (every axis
    odd) > hybrid > aggregation, the geometric kinds only where the
    constant is the near-null vector."""
    if geom_ok and transfer.can_coarsen(g):
        return "fw"
    if geom_ok and _hybrid_applies(g):
        return "hyb"
    if transfer.can_aggregate(g):
        return "agg"
    return None


def galerkin_coarse(A: DiaMatrix, fine: GridShape, kind: str = "fw") -> DiaMatrix:
    """A_c = R A P on the host (setup-time scipy triple product), with the
    full-weighting P and R = P^T / 2^d.  Other transfer kinds are not
    ported yet."""
    if kind != "fw":
        raise NotImplementedError(
            f"galerkin_coarse kind={kind!r} is not ported yet ({_REST_OF_HIERARCHY})"
        )
    S = _dia_to_scipy(A)
    P = transfer.prolong_matrix(fine)
    R = (P.T * (0.5 ** len(fine))).tocsr()
    return _scipy_to_dia(R @ S @ P)


def build_hierarchy(
    A: DiaMatrix,
    grid: GridShape,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    omega: float = 2.0 / 3.0,
    max_coarse: int = 1025,
    max_levels: int = 25,
    dtype=None,
    coarse_operator=None,
    device=None,
) -> MgHierarchy:
    """Build the hierarchy from the host fine operator and place it on
    ``device`` (``None``: the card when there is one).

    Coarse operators are the Galerkin products ``R A P`` (``galerkin_coarse``)
    unless ``coarse_operator(level, coarse_grid) -> DiaMatrix`` rediscretizes
    each coarse level (e.g. ``generators.poisson_coarse_operator``).  The
    transfer decisions are the JAX package's: full weighting while every
    axis is odd and the constant is the near-null vector, semicoarsening
    where an axis couples below ``_SEMI_THETA`` of the strongest (Galerkin
    only), and coarsening stops at ``max_coarse`` unknowns.  Where the JAX
    package would take semicoarsening, hybrid or aggregation transfers the
    build raises ``NotImplementedError`` (those transfers are not ported);
    with ``coarse_operator`` an aggregation step stops the build, as it does
    there.  Never silently full-coarsens in their place.

    ``setup_s`` on the result splits the host-clock seconds into ``detect``
    (stencil conversion, const detection, transfer choice), ``bounds``
    (Chebyshev bounds), ``levels`` (casting legs and ``inv_diag`` to
    ``dtype``), ``galerkin`` (the triple products, or ``coarse_operator``),
    ``coarse_inv`` (the dense inverse) and ``upload`` (placing the
    hierarchy on ``device``, synchronised).
    """
    if int(np.prod(grid)) != A.n:
        raise ValueError(f"prod(grid)={int(np.prod(grid))} != n={A.n}")
    if smoother == "rbgs":
        raise NotImplementedError(f"the rbgs smoother is not ported yet ({_REST_OF_HIERARCHY})")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")

    setup = dict.fromkeys(("detect", "bounds", "levels", "galerkin", "coarse_inv", "upload"), 0.0)
    levels = []
    A_h = A  # host-side numpy DIA
    g = tuple(grid)
    while A_h.n > max_coarse and transfer.can_aggregate(g) and len(levels) < max_levels - 1:
        t0 = time.perf_counter()
        # copy=False: A_st aliases A_h's buffer; both are transient setup
        # state here (A_h is replaced by the next coarse level)
        A_st = dia_to_stencil(A_h, g, copy=False)
        A_const = stencil_to_const(A_st)
        geom_ok = _geometric_ok(A_const, g) if A_const is not None else _const_near_null(A_h, g)
        kind = _pick_kind(g, geom_ok)
        if kind is None:
            break
        if coarse_operator is None and kind in ("fw", "hyb") and len(g) > 1:
            s_ax = (_const_axis_strengths(A_const, g) if A_const is not None
                    else _axis_strengths(A_st))
            if s_ax.max() > 0:
                mask = tuple(bool(v >= _SEMI_THETA * s_ax.max()) for v in s_ax)
                if not all(mask) and transfer.can_partial(g, mask):
                    kind = "semi" + "".join("1" if m else "0" for m in mask)
        if coarse_operator is not None and kind == "agg":
            # no calibrated rediscretization scale for aggregation: the
            # dense coarse inverse takes over at whatever size remains
            break
        if kind != "fw":
            raise NotImplementedError(
                f"{kind!r} transfers for grid {g} are not ported yet ({_REST_OF_HIERARCHY})"
            )
        center = (0,) * len(g)
        if A_const is not None and center in A_const.shifts:
            diag = np.asarray([A_const.coeffs[A_const.shifts.index(center)]],
                              np.asarray(A_h.data).dtype)
        else:
            diag = dia_diagonal(A_h)
        if np.any(diag <= 0):
            raise ValueError("non-positive diagonal; not SPD-compatible with Jacobi scaling")
        t1 = time.perf_counter()
        setup["detect"] += t1 - t0
        if smoother == "chebyshev":
            bounds = (_const_bounds(A_const) if A_const is not None
                      else eigen.scaled_spectrum_bounds(A_h))
        else:
            bounds = (0.0, 0.0)
        t2 = time.perf_counter()
        setup["bounds"] += t2 - t1
        dt = dtype or np.asarray(A_h.data).dtype
        if A_const is not None:
            # zero matrix bytes per SpMV, scalar inv_diag
            inv_d = torch.from_numpy(np.asarray(1.0 / diag[0], dtype=dt).reshape(()))
            levels.append(MgLevel(A_const, inv_d, g, bounds, "fw"))
        else:
            inv_d = torch.from_numpy((1.0 / diag).astype(dt).reshape(g))
            # legs assembled on the host; the whole hierarchy moves once, below
            levels.append(MgLevel(A_st.device_put(dt, "cpu"), inv_d, g, bounds, "fw"))
        t3 = time.perf_counter()
        setup["levels"] += t3 - t2
        g_next = transfer.coarse_shape(g)
        if coarse_operator is not None:
            A_h = coarse_operator(len(levels), g_next)
            if int(np.prod(g_next)) != A_h.n:
                raise ValueError(f"coarse_operator returned n={A_h.n} for grid {g_next}")
        else:
            A_h = galerkin_coarse(A_h, g, "fw")
        setup["galerkin"] += time.perf_counter() - t3
        g = g_next

    if coarse_operator is not None and A_h.n > 4 * max_coarse:
        # never silently densify a large remainder
        raise ValueError(
            f"rediscretized coarsening stopped at n={A_h.n} > 4*max_coarse="
            f"{4 * max_coarse} (grid {g}: axes not fw-coarsenable); fix the grid "
            "sizes (2^k - 1 axes) or raise max_coarse explicitly"
        )
    t0 = time.perf_counter()
    dt = dtype or np.asarray(A_h.data).dtype
    dense = dia_to_dense(A_h)
    coarse_inv = torch.from_numpy(np.linalg.inv(np.asarray(dense, dtype=np.float64)).astype(dt))
    h = MgHierarchy(levels, coarse_inv, smoother, pre, post, omega)
    t1 = time.perf_counter()
    h = h.to(default_device(device))
    if h.coarse_inv.device.type == "cuda":
        torch.cuda.synchronize(h.coarse_inv.device)
    setup.update(coarse_inv=t1 - t0, upload=time.perf_counter() - t1)
    h.setup_s = setup
    return h


def _fused_cheb_ok(lvl: MgLevel, b: torch.Tensor) -> bool:
    """Gate for the fused Chebyshev kernel: a 3-D const level with a scalar
    ``inv_diag``, per-axis shifts in {-1, 0, 1}, and fp32 state."""
    return (
        isinstance(lvl.A, ConstStencilMatrix)
        and len(lvl.grid) == 3
        and lvl.inv_diag.ndim == 0
        and b.dtype == torch.float32
        and all(abs(s) <= 1 for sh in lvl.A.shifts for s in sh)
    )


def _smooth(h: MgHierarchy, lvl: MgLevel, op, b, x, sweeps: int, x_zero: bool = False,
            fused: bool = False):
    if sweeps <= 0:
        return x
    if h.smoother == "chebyshev":
        lo, hi = lvl.cheb_bounds
        if fused:
            return cheb_smooth_const_cuda(
                lvl.A, b, None if x_zero else x, sweeps, hi, lo, lvl.inv_diag
            )
        return chebyshev_smooth(op, lvl.inv_diag, b, x, sweeps, hi, lo)
    return jacobi_smooth(op, lvl.inv_diag, b, x, sweeps, h.omega)


def _level_transfers(lvl: MgLevel):
    """(restrict, prolong) for a level, on grid-shaped tensors."""
    if lvl.transfer != "fw":
        raise NotImplementedError(
            f"{lvl.transfer!r} transfers are not ported yet ({_REST_OF_HIERARCHY})"
        )
    return transfer.restrict_grid, transfer.prolong_grid


def v_cycle(h: MgHierarchy, b: torch.Tensor, level: int = 0) -> torch.Tensor:
    """One V-cycle for A_level e = b from a zero initial guess.  Flat input
    runs grid-shaped and comes back flat."""
    if level == len(h.levels):
        return torch.matmul(h.coarse_inv, b.reshape(-1)).reshape(b.shape)
    lvl = h.levels[level]
    if tuple(b.shape) != lvl.grid:
        return v_cycle(h, b.reshape(lvl.grid), level).reshape(-1)
    op = as_operator(lvl.A)
    fused = h.smoother == "chebyshev" and _fused_cheb_ok(lvl, b)
    r = None
    if fused and h.pre > 0:
        # fused pre-smooth + residual: the kernel emits the smoothed x and
        # r_s = D^{-1}(b - A x); the correction needs r = r_s / inv_diag
        lo, hi = lvl.cheb_bounds
        x, r_s = cheb_smooth_const_cuda(lvl.A, b, None, h.pre, hi, lo, lvl.inv_diag,
                                        want_resid=True)
        r = r_s / lvl.inv_diag
    else:
        x = _smooth(h, lvl, op, b, torch.zeros_like(b), h.pre, x_zero=True, fused=fused)
    rg, pg = _level_transfers(lvl)
    if r is None:
        r = b - op(x)
    x = x + pg(v_cycle(h, rg(r), level + 1), lvl.grid)
    return _smooth(h, lvl, op, b, x, h.post, fused=fused)


def fmg(*args, **kwargs):
    """Full multigrid is not ported yet."""
    raise NotImplementedError(f"fmg is not ported yet ({_REST_OF_HIERARCHY})")


def as_preconditioner(h: MgHierarchy) -> Callable[[torch.Tensor], torch.Tensor]:
    """M(r) = one V-cycle, the "Mg" in MGCG (SPD by symmetric construction).

    The coarsest solve is a dense fp32 matvec, which must not run in TF32
    (about three decimal digits): this entry point turns CUDA matmul TF32
    off for the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return partial(v_cycle, h, level=0)


def mgcg_solve(
    A: DiaMatrix,
    b,
    grid: GridShape,
    x0=None,
    policy=None,
    smoother: str = "chebyshev",
    pre: int = 2,
    post: int = 2,
    hierarchy: Optional[MgHierarchy] = None,
    precise_dot: bool = False,
    coarse_operator=None,
    dtype=None,
    device=None,
):
    """Multigrid-preconditioned CG: builds (or reuses) the hierarchy, then
    runs CG with one V-cycle per iteration as M.  Returns
    ``(CGResult, MgHierarchy)`` with a flat ``x``.  The operator is the fine
    level's stencil; a hierarchy without levels (the whole system below
    ``max_coarse``) runs flat on ``A`` as DIA, its V-cycle the dense
    inverse, as the JAX package does.  The solve runs where the hierarchy
    lies: a built one on ``device`` (``None``: the card when there is
    one).  ``b`` and ``x0`` may be host arrays or torch tensors on any
    device; a tensor moves to the hierarchy's device and dtype directly."""
    from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    h = hierarchy
    if h is None:
        h = build_hierarchy(A, grid, smoother=smoother, pre=pre, post=post, dtype=dtype,
                            coarse_operator=coarse_operator, device=device)
    dev = h.coarse_inv.device
    tdt = h.coarse_inv.dtype
    if h.levels:
        A_dev, shape = h.levels[0].A, tuple(grid)
    else:
        A_dev, shape = A.device_put(tdt, dev), (A.n,)
    b = place(b, tdt, dev).reshape(shape)
    if x0 is not None:
        x0 = place(x0, tdt, dev).reshape(shape)
    result = cg_solve(A_dev, b, x0, policy, M=as_preconditioner(h), precise_dot=precise_dot)
    result = CGResult(x=result.x.reshape(-1), iterations=result.iterations,
                      residual=result.residual, converged=result.converged)
    return result, h
