"""Geometric multigrid: hierarchy setup, V- and W-cycles, full multigrid and
the MGCG preconditioner.

The port of ``conjugategradient_tpu/precond/multigrid.py``.  Setup is
host-side numpy and scipy; the hierarchy is an ``nn.Module`` whose per-level
``inv_diag``, variable-coefficient ``legs``, aggregation ``weight``,
red-black ``mask`` and ``coarse_inv`` are registered buffers, so
``.to(device)`` moves it.

Transfers (``precond.transfer``), chosen per level as the JAX package
chooses them: full weighting (``fw``) while every axis is odd, hybrid
fw/cell-centered (``hyb``) on even axes, semicoarsening (``semi…``) of the
strongly coupled axes under anisotropy, and smoothed aggregation (``agg``)
where the near-null vector alternates in sign or no geometric transfer
applies.  Coarse operators are the Galerkin products ``R A P`` unless a
rediscretization hook (``coarse_operator``) replaces them; the coarsest grid
is solved with a dense inverse.

A level whose operator is constant over the grid (the Poisson ladder)
const-detects to a ``ConstStencilMatrix`` with a scalar ``inv_diag`` and
Gershgorin Chebyshev bounds; any other level keeps its legs (a
``StencilMatrix`` over the ``legs`` buffer, kernel #3 on the card: the tuned
kernel at halo 1, the wide one at the halo-2 Galerkin levels of the hyb,
semi and agg transfers), a grid-shaped ``inv_diag`` and bounds from the host
power iteration.  ``layout="dia"`` keeps flat ``DiaMatrix`` levels and flat
vectors (kernel #4).  On a 3-D const level with fp32 state the Chebyshev
smoothing runs fused (``ops.cuda_stencil.cheb_smooth_const_cuda``); every
other level, and every fp64 run, takes the unfused smoothers built from the
SpMV kernels.
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
from conjugategradient_tpu_torch.precond.smoothers import (
    chebyshev_smooth,
    jacobi_smooth,
    parity_mask,
    redblack_gs_smooth,
    redblack_gs_smooth_reversed,
)
from conjugategradient_tpu_torch.solvers import eigen

GridShape = Tuple[int, ...]


class MgLevel(nn.Module):
    """One level: operator, ``1/diag`` buffer (a scalar on a const level,
    grid-shaped on a variable one, flat on a DIA one), grid geometry,
    Chebyshev bounds of D^{-1}A and the transfer kind.

    A variable-coefficient or DIA level registers its legs as the buffer
    ``legs`` and builds ``A`` over that buffer on every access, so
    ``.to(device)`` (or a dtype cast) moves the operator with the level.
    ``weight`` (the aggregation weights of an agg level) and ``mask`` (the
    checkerboard of the rbgs smoother) are buffers too, ``None`` where the
    level has none; ``sa_smooth`` says whether an agg level's transfers are
    smoothed by ``(I - c D^{-1}A)``."""

    def __init__(self, A, inv_diag: torch.Tensor, grid: GridShape,
                 cheb_bounds: Tuple[float, float], transfer: str = "fw",
                 weight: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
                 sa_smooth: bool = True):
        super().__init__()
        self._const = self.shifts = self.offsets = None
        if isinstance(A, (StencilMatrix, DiaMatrix)):
            if isinstance(A, StencilMatrix):
                self.shifts = tuple(A.shifts)
            else:
                self.offsets = tuple(A.offsets)
            legs = A.data if torch.is_tensor(A.data) else torch.from_numpy(np.asarray(A.data))
            self.register_buffer("legs", legs.contiguous())
        else:
            self._const = A
        self.register_buffer("inv_diag", inv_diag)
        self.register_buffer("weight", weight)
        self.register_buffer("mask", mask)
        self.grid = tuple(grid)
        self.cheb_bounds = tuple(cheb_bounds)
        self.transfer = transfer
        self.sa_smooth = sa_smooth

    @property
    def A(self):
        """The level's operator: the ``ConstStencilMatrix``, or a
        ``StencilMatrix`` or ``DiaMatrix`` over the current ``legs`` buffer."""
        if self._const is not None:
            return self._const
        if self.offsets is not None:
            n = int(np.prod(self.grid))
            return DiaMatrix(self.legs, self.offsets, (n, n))
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


#: smoothed-aggregation damping: omega = 4 / (3 * lam_max(D^{-1}A))
_SA_W = 4.0 / 3.0


def _checkerboard(grid: GridShape) -> np.ndarray:
    return np.where(np.indices(grid).sum(axis=0).reshape(-1) % 2 == 0, 1.0, -1.0)


def _near_null(A_h: DiaMatrix, grid: GridShape) -> np.ndarray:
    """Near-null candidate for the aggregation coarse space: whichever of
    the constant and the checkerboard-alternating vector has the smaller
    Rayleigh quotient (the constant for negative off-diagonals, the
    alternating vector for the (+1, 2, +1) tridiagonal)."""
    best, best_q = None, np.inf
    for z in (np.ones(A_h.n), _checkerboard(grid)):
        q = float(z @ oracle.spmv(A_h, z)) / float(z @ z)
        if q < best_q:
            best, best_q = z, q
    return best


def _const_near_null(A_h: DiaMatrix, grid: GridShape) -> bool:
    """True iff the constant (not the checkerboard) is the near-null
    candidate, the precondition for geometric transfers: the two Rayleigh
    numerators ones.A.ones and alt.A.alt by the host oracle."""
    ones = np.ones(A_h.n)
    alt = _checkerboard(grid)
    q1 = float(ones @ oracle.spmv(A_h, ones))
    q2 = float(alt @ oracle.spmv(A_h, alt))
    return q1 <= q2


def _axis_strengths(A_h: DiaMatrix, grid: GridShape, st=None) -> np.ndarray:
    """Per-axis coupling strength: max |value| over the axis-aligned
    off-diagonal stencil legs (the semicoarsening detector); ``st`` is the
    stencil form when it already exists."""
    if st is None:
        st = dia_to_stencil(A_h, grid)
    d = len(grid)
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


def _agg_weights(z: np.ndarray, grid: GridShape):
    """Per-aggregate-normalised candidate -> (W, z_coarse): ``diag(W) @
    P_plain`` has orthonormal columns and reproduces ``z`` exactly."""
    zz = (z * z).reshape(grid)
    for ax in range(len(grid)):
        m = zz.shape[ax]
        zm = np.moveaxis(zz, ax, -1)
        if m % 2:
            zm = np.concatenate([zm, np.zeros(zm.shape[:-1] + (1,))], axis=-1)
        zm = zm.reshape(zm.shape[:-1] + (-1, 2)).sum(axis=-1)
        zz = np.moveaxis(zm, -1, ax)
    nrm = np.sqrt(zz)  # coarse-grid aggregate norms
    expand = nrm
    for ax in range(len(grid)):
        expand = np.moveaxis(
            np.repeat(np.moveaxis(expand, ax, -1), 2, axis=-1)[..., : grid[ax]], -1, ax
        )
    expand = expand.reshape(-1)
    ok = expand > 0
    W = np.where(ok, z / np.where(ok, expand, 1.0), 1.0)
    return W, nrm.reshape(-1)


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


def _semi_mask(kind: str):
    """Decode "semi101..." -> per-axis coarsen mask."""
    return tuple(c == "1" for c in kind[len("semi"):])


def _coarse_shape_of(g: GridShape, kind: str) -> GridShape:
    if kind == "fw":
        return transfer.coarse_shape(g)
    if kind == "hyb":
        return transfer.hybrid_coarse_shape(g)
    if kind.startswith("semi"):
        return transfer.partial_coarse_shape(g, _semi_mask(kind))
    return transfer.agg_coarse_shape(g)


def galerkin_coarse(
    A: DiaMatrix,
    fine: GridShape,
    kind: str = "fw",
    lam_max: float | None = None,
    weight: np.ndarray | None = None,
    sa_smooth: bool = True,
) -> DiaMatrix:
    """A_c = R A P on the host (setup-time scipy triple product).

    ``kind``: "fw", "hyb" or "semi…" (the geometric transfers, R = P^T / 2
    per coarsened axis), or "agg": the tentative prolongator ``diag(weight)
    P_plain`` (``weight`` from ``_agg_weights`` of the near-null candidate,
    computed here when not given), smoothed once by ``(I - omega D^{-1} A)``
    with omega = 4 / (3 lam_max) when ``sa_smooth``.
    """
    S = _dia_to_scipy(A)
    if kind == "fw":
        P = transfer.prolong_matrix(fine)
    elif kind == "hyb":
        P = transfer.prolong_hybrid_matrix(fine)
    elif kind.startswith("semi"):
        mask = _semi_mask(kind)
        P = transfer.prolong_partial_matrix(fine, mask)
        R = (P.T * (0.5 ** sum(mask))).tocsr()
        return _scipy_to_dia((R @ S @ P).tocsr())
    else:
        P = transfer.prolong_agg_matrix(fine)
        if weight is None:
            weight, _ = _agg_weights(_near_null(A, fine), fine)
        P = sp.diags(np.asarray(weight).reshape(-1)) @ P
        if sa_smooth:
            if lam_max is None:
                lam_max = eigen.scaled_spectrum_bounds(A)[1]
            Dinv = sp.diags(1.0 / dia_diagonal(A))
            P = (P - (_SA_W / lam_max) * (Dinv @ (S @ P))).tocsr()
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
    layout: str = "stencil",
    sa_smooth_levels: int | None = None,
    const_detect: bool = True,
    transfer_kind: str = "auto",
    coarse_operator=None,
    semicoarsen: bool = True,
    semi_theta: float = 0.25,
    device=None,
) -> MgHierarchy:
    """Build the hierarchy from the host fine operator and place it on
    ``device`` (``None``: the card when there is one).

    The JAX package's build, decision for decision.  ``transfer_kind="auto"``
    takes full weighting while every axis is odd, else hybrid while every
    resulting coarse axis is >= 5 (both only where the constant is the
    near-null vector), else aggregation; ``"fw"``, ``"hyb"`` or ``"agg"``
    forces one kind while it applies.  With ``semicoarsen`` (Galerkin,
    auto) an axis coupled below ``semi_theta`` of the strongest is not
    coarsened.  Coarsening stops at ``max_coarse`` unknowns.

    ``layout="stencil"`` stores each level as a grid stencil (const-detected
    unless ``const_detect=False``); ``layout="dia"`` keeps flat DIA levels.
    ``sa_smooth_levels`` smooths the aggregation prolongator on the first k
    agg levels only (None: all).  ``coarse_operator(level, coarse_grid) ->
    DiaMatrix`` rediscretizes each coarse level (e.g.
    ``generators.poisson_coarse_operator``); it assumes the geometric fw/hyb
    conventions, so ``transfer_kind="agg"`` raises, an aggregation step
    stops the build, and a build that stops above ``4 * max_coarse`` raises
    rather than densify a large remainder.

    ``setup_s`` on the result splits the host-clock seconds into ``detect``
    (stencil conversion, const detection, transfer choice), ``bounds``
    (Chebyshev bounds), ``near_null`` (the aggregation candidate and
    weights), ``levels`` (casting legs and ``inv_diag`` to ``dtype``),
    ``galerkin`` (the triple products, or ``coarse_operator``),
    ``coarse_inv`` (the dense inverse) and ``upload`` (placing the hierarchy
    on ``device``, synchronised).
    """
    if layout not in ("stencil", "dia"):
        raise ValueError(f"unknown layout {layout!r}")
    if transfer_kind not in ("auto", "fw", "hyb", "agg"):
        raise ValueError(f"unknown transfer_kind {transfer_kind!r}")
    if int(np.prod(grid)) != A.n:
        raise ValueError(f"prod(grid)={int(np.prod(grid))} != n={A.n}")
    if smoother not in ("jacobi", "chebyshev", "rbgs"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_operator is not None and transfer_kind == "agg":
        raise ValueError(
            "coarse_operator (rediscretization) assumes the geometric "
            "fw/hyb transfer conventions; transfer_kind='agg' has no fixed "
            "calibration"
        )

    def _pick_kind(gg, geom_ok=True):
        if transfer_kind != "auto":
            can = {"fw": transfer.can_coarsen, "hyb": transfer.can_hybrid,
                   "agg": transfer.can_aggregate}[transfer_kind]
            return transfer_kind if can(gg) else None
        if geom_ok and transfer.can_coarsen(gg):
            return "fw"
        # hyb only while every coarse axis stays >= 5: its Galerkin
        # operators have extent 2, and on smaller axes distinct shifts
        # alias one flat offset
        if geom_ok and transfer.can_hybrid(gg) and all(
            n >= 5 for n in transfer.hybrid_coarse_shape(gg)
        ):
            return "hyb"
        if transfer.can_aggregate(gg):
            return "agg"
        return None

    setup = dict.fromkeys(("detect", "bounds", "near_null", "levels", "galerkin", "coarse_inv",
                           "upload"), 0.0)
    levels = []
    A_h = A  # host-side numpy DIA
    g = tuple(grid)
    while A_h.n > max_coarse and _pick_kind(g) is not None and len(levels) < max_levels - 1:
        t0 = time.perf_counter()
        A_st = A_const = None
        if layout == "stencil":
            # copy=False: A_st aliases A_h's buffer; both are transient setup
            # state here (A_h is replaced by the next coarse level)
            A_st = dia_to_stencil(A_h, g, copy=False)
            A_const = stencil_to_const(A_st) if const_detect else None
        geom_ok = _geometric_ok(A_const, g) if A_const is not None else _const_near_null(A_h, g)
        kind = _pick_kind(g, geom_ok=geom_ok)
        if kind is None:
            break
        if (semicoarsen and coarse_operator is None and transfer_kind == "auto"
                and kind in ("fw", "hyb") and len(g) > 1):
            s_ax = (_const_axis_strengths(A_const, g) if A_const is not None
                    else _axis_strengths(A_h, g, st=A_st))
            if s_ax.max() > 0:
                mask = tuple(bool(v >= semi_theta * s_ax.max()) for v in s_ax)
                if not all(mask) and transfer.can_partial(g, mask):
                    kind = "semi" + "".join("1" if m else "0" for m in mask)
        if coarse_operator is not None and kind == "agg":
            # no calibrated rediscretization scale for aggregation: the
            # dense coarse inverse takes over at whatever size remains
            break
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
        if smoother == "chebyshev" or kind == "agg":
            # an agg level's transfers need lam_max: the power iteration,
            # even on a const level
            bounds = (_const_bounds(A_const) if A_const is not None and kind != "agg"
                      else eigen.scaled_spectrum_bounds(A_h))
        else:
            bounds = (0.0, 0.0)
        t2 = time.perf_counter()
        setup["bounds"] += t2 - t1
        W_host = None
        sa_smooth = sa_smooth_levels is None or len(levels) < sa_smooth_levels
        if kind == "agg":
            W_host, _ = _agg_weights(_near_null(A_h, g), g)
        t3 = time.perf_counter()
        setup["near_null"] += t3 - t2
        dt = dtype or np.asarray(A_h.data).dtype
        # assembled on the host; the whole hierarchy moves once, below
        if layout == "stencil":
            if A_const is not None:
                # zero matrix bytes per SpMV, scalar inv_diag
                A_lvl = A_const
                inv_d = torch.from_numpy(np.asarray(1.0 / diag[0], dtype=dt).reshape(()))
            else:
                A_lvl = A_st.device_put(dt, "cpu")
                inv_d = torch.from_numpy((1.0 / diag).astype(dt).reshape(g))
            mask = parity_mask(g) if smoother == "rbgs" else None
            W = None if W_host is None else torch.from_numpy(W_host.astype(dt).reshape(g))
        else:
            A_lvl = A_h.device_put(dt, "cpu")
            inv_d = torch.from_numpy((1.0 / diag).astype(dt))
            mask = parity_mask((A_h.n,)) if smoother == "rbgs" else None
            W = None if W_host is None else torch.from_numpy(W_host.astype(dt))
        levels.append(MgLevel(A_lvl, inv_d, g, bounds, kind, weight=W, mask=mask,
                              sa_smooth=sa_smooth))
        t4 = time.perf_counter()
        setup["levels"] += t4 - t3
        g_next = _coarse_shape_of(g, kind)
        if coarse_operator is not None:
            A_h = coarse_operator(len(levels), g_next)
            if int(np.prod(g_next)) != A_h.n:
                raise ValueError(f"coarse_operator returned n={A_h.n} for grid {g_next}")
        else:
            A_h = galerkin_coarse(A_h, g, kind, lam_max=bounds[1] or None, weight=W_host,
                                  sa_smooth=sa_smooth)
        setup["galerkin"] += time.perf_counter() - t4
        g = g_next

    if coarse_operator is not None and A_h.n > 4 * max_coarse:
        # never silently densify a large remainder
        raise ValueError(
            f"rediscretized coarsening stopped at n={A_h.n} > 4*max_coarse="
            f"{4 * max_coarse} (grid {g}: axes not fw/hyb-coarsenable, or "
            "the near-null probe forced aggregation); fix the grid sizes "
            "(2^k or 2^k-1 axes) or raise max_coarse explicitly"
        )
    t0 = time.perf_counter()
    dt = dtype or np.asarray(A_h.data).dtype
    dense = dia_to_dense(A_h).data
    coarse_inv = torch.from_numpy(np.linalg.inv(np.asarray(dense, dtype=np.float64)).astype(dt))
    h = MgHierarchy(levels, coarse_inv, smoother, pre, post, omega)
    t1 = time.perf_counter()
    h = h.to(default_device(device))
    if h.coarse_inv.device.type == "cuda":
        torch.cuda.synchronize(h.coarse_inv.device)
    setup.update(coarse_inv=t1 - t0, upload=time.perf_counter() - t1)
    h.setup_s = setup
    return h


def _grid_native(lvl: MgLevel) -> bool:
    return isinstance(lvl.A, (StencilMatrix, ConstStencilMatrix))


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


def _smooth(h: MgHierarchy, lvl: MgLevel, op, b, x, sweeps: int, post: bool = False,
            x_zero: bool = False, fused: bool = False):
    if sweeps <= 0:
        return x
    if h.smoother == "chebyshev":
        lo, hi = lvl.cheb_bounds
        if fused:
            return cheb_smooth_const_cuda(
                lvl.A, b, None if x_zero else x, sweeps, hi, lo, lvl.inv_diag
            )
        return chebyshev_smooth(op, lvl.inv_diag, b, x, sweeps, hi, lo)
    if h.smoother == "rbgs":
        fn = redblack_gs_smooth_reversed if post else redblack_gs_smooth
        return fn(op, lvl.inv_diag, b, x, sweeps, lvl.mask)
    return jacobi_smooth(op, lvl.inv_diag, b, x, sweeps, h.omega)


def _level_transfers(lvl: MgLevel, op):
    """(restrict, prolong) for a level, on grid-shaped tensors.

    An agg level's transfers are the adjoints of the scipy P of its
    Galerkin product: P = (I - c D^{-1}A) diag(W) P_plain with
    c = 4 / (3 lam_max) (``sa_smooth``; plain weighted aggregation without
    it), R = P^T / 2^d.  The smoothed ones apply the level's operator, so
    they run its SpMV kernel.  On a DIA level, ``op``, ``inv_diag`` and
    ``W`` are flat: the transfers flatten around them."""
    if lvl.transfer == "fw":
        return transfer.restrict_grid, transfer.prolong_grid
    if lvl.transfer == "hyb":
        return transfer.restrict_hybrid_grid, transfer.prolong_hybrid_grid
    if lvl.transfer.startswith("semi"):
        mask = _semi_mask(lvl.transfer)
        return (
            lambda r: transfer.restrict_partial_grid(r, mask),
            lambda e, fine: transfer.prolong_partial_grid(e, fine, mask),
        )
    W = lvl.weight
    if not lvl.sa_smooth:
        if _grid_native(lvl):
            return (
                lambda r: transfer.restrict_agg_grid(W * r),
                lambda e, fine: W * transfer.prolong_agg_grid(e, fine),
            )
        return (
            lambda r: transfer.restrict_agg_grid((W * r.reshape(-1)).reshape(r.shape)),
            lambda e, fine: (W * transfer.prolong_agg_grid(e, fine).reshape(-1)).reshape(fine),
        )
    c = _SA_W / lvl.cheb_bounds[1]
    if _grid_native(lvl):

        def rg(r):
            return transfer.restrict_agg_grid(W * (r - c * op(lvl.inv_diag * r)))

        def pg(e, fine):
            w = W * transfer.prolong_agg_grid(e, fine)
            return w - c * (lvl.inv_diag * op(w))

    else:

        def rg(r):
            rf = r.reshape(-1)
            s = W * (rf - c * op(lvl.inv_diag * rf))
            return transfer.restrict_agg_grid(s.reshape(r.shape))

        def pg(e, fine):
            w = W * transfer.prolong_agg_grid(e, fine).reshape(-1)
            return (w - c * (lvl.inv_diag * op(w))).reshape(fine)

    return rg, pg


def _coarse_solve(h: MgHierarchy, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(h.coarse_inv, b.reshape(-1)).reshape(b.shape)


def v_cycle(h: MgHierarchy, b: torch.Tensor, level: int = 0, gamma: int = 1,
            x0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One multigrid cycle for A_level e = b, from a zero initial guess or
    ``x0``.  ``gamma`` is the cycle index: 1 a V-cycle, 2 a W-cycle (the
    coarse correction recurses twice below the top level).  On a
    grid-stencil hierarchy flat input runs grid-shaped and comes back
    flat."""
    if level == len(h.levels):
        return _coarse_solve(h, b)
    lvl = h.levels[level]
    grid_native = _grid_native(lvl)
    if grid_native and tuple(b.shape) != lvl.grid:
        x0g = None if x0 is None else x0.reshape(lvl.grid)
        return v_cycle(h, b.reshape(lvl.grid), level, gamma, x0g).reshape(-1)
    op = as_operator(lvl.A)
    fused = h.smoother == "chebyshev" and _fused_cheb_ok(lvl, b)
    r_pre = None
    if fused and h.pre > 0 and x0 is None:
        # fused pre-smooth + residual: the kernel emits the smoothed x and
        # r_s = D^{-1}(b - A x); the correction needs r = r_s / inv_diag
        lo, hi = lvl.cheb_bounds
        x, r_s = cheb_smooth_const_cuda(lvl.A, b, None, h.pre, hi, lo, lvl.inv_diag,
                                        want_resid=True)
        r_pre = r_s / lvl.inv_diag
    else:
        x = torch.zeros_like(b) if x0 is None else x0
        x = _smooth(h, lvl, op, b, x, h.pre, x_zero=x0 is None, fused=fused)
    rg, pg = _level_transfers(lvl, op)

    def correct(x, r=None):
        if r is None:
            r = b - op(x)
        if grid_native:
            return x + pg(v_cycle(h, rg(r), level + 1, gamma), lvl.grid)
        cg_shape = _coarse_shape_of(lvl.grid, lvl.transfer)
        ec = v_cycle(h, rg(r.reshape(lvl.grid)).reshape(-1), level + 1, gamma)
        return x + pg(ec.reshape(cg_shape), lvl.grid).reshape(-1)

    for j in range(gamma if level > 0 else 1):  # the cycle index applies below the top
        x = correct(x, r_pre if j == 0 else None)
    return _smooth(h, lvl, op, b, x, h.post, post=True, fused=fused)


def fmg(h: MgHierarchy, b: torch.Tensor) -> torch.Tensor:
    """Full multigrid: restrict b down the hierarchy (with the V-cycle's own
    transfers), solve the coarsest grid directly, then on each level up
    prolong and run one V-cycle from that guess.  One pass gives an
    O(discretisation-accuracy) initial guess; pair it with a few MGCG
    iterations for tighter tolerances."""
    grid_native = len(h.levels) > 0 and _grid_native(h.levels[0])
    flat_in = grid_native and tuple(b.shape) != h.levels[0].grid
    if flat_in:
        b = b.reshape(h.levels[0].grid)
    bs = [b]
    for lvl in h.levels:
        rg, _ = _level_transfers(lvl, as_operator(lvl.A))
        bs.append(rg(bs[-1]) if grid_native else rg(bs[-1].reshape(lvl.grid)).reshape(-1))
    x = _coarse_solve(h, bs[-1])
    for level in range(len(h.levels) - 1, -1, -1):
        lvl = h.levels[level]
        _, pg = _level_transfers(lvl, as_operator(lvl.A))
        if grid_native:
            x = pg(x, lvl.grid)
        else:
            x = pg(x.reshape(_coarse_shape_of(lvl.grid, lvl.transfer)), lvl.grid).reshape(-1)
        x = v_cycle(h, bs[level], level, x0=x)
    return x.reshape(-1) if flat_in else x


def as_preconditioner(h: MgHierarchy, gamma: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """M(r) = one V-cycle (``gamma=1``) or W-cycle (``gamma=2``), the "Mg"
    in MGCG (SPD by symmetric construction).

    The coarsest solve is a dense fp32 matvec, which must not run in TF32
    (about three decimal digits): this entry point turns CUDA matmul TF32
    off for the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return partial(v_cycle, h, level=0, gamma=gamma)


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
    layout: str = "stencil",
    gamma: int = 1,
):
    """Multigrid-preconditioned CG: builds (or reuses) the hierarchy, then
    runs CG with one cycle per iteration as M (``gamma=2``: W-cycles).
    Returns ``(CGResult, MgHierarchy)`` with a flat ``x``.  The operator is
    the fine level's (its stencil, or its DIA with ``layout="dia"``); a
    hierarchy without levels (the whole system below ``max_coarse``) runs
    flat on ``A`` as DIA, its cycle the dense inverse, as the JAX package
    does.  The solve runs where the hierarchy lies: a built one on
    ``device`` (``None``: the card when there is one).  ``b`` and ``x0`` may
    be host arrays or torch tensors on any device; a tensor moves to the
    hierarchy's device and dtype directly."""
    from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    h = hierarchy
    if h is None:
        h = build_hierarchy(A, grid, smoother=smoother, pre=pre, post=post, dtype=dtype,
                            layout=layout, coarse_operator=coarse_operator, device=device)
    dev = h.coarse_inv.device
    tdt = h.coarse_inv.dtype
    if h.levels:
        A_dev = h.levels[0].A
        shape = tuple(grid) if _grid_native(h.levels[0]) else (A.n,)
    else:
        A_dev, shape = A.device_put(tdt, dev), (A.n,)
    b = place(b, tdt, dev).reshape(shape)
    if x0 is not None:
        x0 = place(x0, tdt, dev).reshape(shape)
    result = cg_solve(A_dev, b, x0, policy, M=as_preconditioner(h, gamma), precise_dot=precise_dot)
    result = CGResult(x=result.x.reshape(-1), iterations=result.iterations,
                      residual=result.residual, converged=result.converged)
    return result, h
