"""Geometric multigrid: hierarchy setup, V-cycle and the MGCG preconditioner.

The slice of ``conjugategradient_tpu/precond/multigrid.py`` that the Poisson
MGCG path runs: grid-shaped (stencil) levels that const-detect to
``ConstStencilMatrix``, full-weighting transfers, a rediscretized coarse
operator per level, and a dense inverse on the coarsest grid.  Setup is
host-side numpy; the hierarchy is an ``nn.Module`` whose per-level
``inv_diag`` and ``coarse_inv`` are registered buffers, so ``.to(device)``
moves it.

On a 3-D const level with fp32 state the Chebyshev smoothing runs fused
(``ops.cuda_stencil.cheb_smooth_const_cuda``): the kernel on the card, its
twin on the CPU.  Every other level, and every fp64 run, takes the unfused
``chebyshev_smooth`` built from the SpMV kernel.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import numpy as np
import torch
from torch import nn

from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    dia_diagonal,
    dia_to_dense,
    dia_to_stencil,
    stencil_to_const,
)
from conjugategradient_tpu_torch.ops.cuda_stencil import cheb_smooth_const_cuda
from conjugategradient_tpu_torch.ops.spmv import as_operator
from conjugategradient_tpu_torch.precond import transfer
from conjugategradient_tpu_torch.precond.smoothers import chebyshev_smooth, jacobi_smooth

GridShape = Tuple[int, ...]

_REST_OF_HIERARCHY = "ROADMAP queue 1 item 9 (the rest of the hierarchy)"


class MgLevel(nn.Module):
    """One level: const-stencil operator, scalar ``1/diag`` buffer, grid
    geometry, Chebyshev bounds of D^{-1}A and the transfer kind."""

    def __init__(self, A: ConstStencilMatrix, inv_diag: torch.Tensor, grid: GridShape,
                 cheb_bounds: Tuple[float, float], transfer: str = "fw"):
        super().__init__()
        self.A = A
        self.register_buffer("inv_diag", inv_diag)
        self.grid = tuple(grid)
        self.cheb_bounds = tuple(cheb_bounds)
        self.transfer = transfer


class MgHierarchy(nn.Module):
    """Static hierarchy: ``levels[0]`` is the fine grid; the coarsest grid is
    solved with the dense inverse ``coarse_inv``."""

    def __init__(self, levels, coarse_inv: torch.Tensor, smoother: str, pre: int,
                 post: int, omega: float):
        super().__init__()
        self.levels = nn.ModuleList(levels)
        self.register_buffer("coarse_inv", coarse_inv)
        self.smoother = smoother
        self.pre = pre
        self.post = post
        self.omega = omega

    @property
    def n_levels(self) -> int:
        return len(self.levels) + 1  # + coarsest direct level


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
    """True iff the constant (not the checkerboard) is the near-null vector,
    the precondition for geometric transfers: the closed form of the two
    Rayleigh quotients ones.A.ones and alt.A.alt of a const stencil (each leg
    counts once per valid position, times (-1)^{sum s} when alternating)."""

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
    device="cpu",
) -> MgHierarchy:
    """Build the hierarchy from the host fine operator and place it on
    ``device``.

    ``coarse_operator(level, coarse_grid) -> DiaMatrix`` rediscretizes each
    coarse level (e.g. ``generators.poisson_coarse_operator``); it is
    required, as the Galerkin product is not ported.  Coarsening uses full
    weighting while every axis is odd and the constant is the near-null
    vector, and stops at ``max_coarse`` unknowns; where the JAX package
    would fall back to aggregation the build stops as it does there.
    """
    if int(np.prod(grid)) != A.n:
        raise ValueError(f"prod(grid)={int(np.prod(grid))} != n={A.n}")
    if smoother == "rbgs":
        raise NotImplementedError(f"the rbgs smoother is not ported yet ({_REST_OF_HIERARCHY})")
    if smoother not in ("jacobi", "chebyshev"):
        raise ValueError(f"unknown smoother {smoother!r}")
    if coarse_operator is None:
        raise NotImplementedError(
            "Galerkin coarsening (galerkin_coarse) is not ported yet; pass "
            f"coarse_operator= ({_REST_OF_HIERARCHY})"
        )

    levels = []
    A_h = A  # host-side numpy DIA
    g = tuple(grid)
    while A_h.n > max_coarse and len(levels) < max_levels - 1 and all(n >= 2 for n in g):
        A_const = stencil_to_const(dia_to_stencil(A_h, g, copy=False))
        if A_const is None:
            raise NotImplementedError(
                "variable-coefficient levels are not ported yet "
                f"(ROADMAP queue 2 kernel #3 and {_REST_OF_HIERARCHY})"
            )
        geom_ok = _geometric_ok(A_const, g)
        if not (geom_ok and transfer.can_coarsen(g)):
            if geom_ok and _hybrid_applies(g):
                raise NotImplementedError(
                    f"hybrid (hyb) transfers for grid {g} are not ported yet ({_REST_OF_HIERARCHY})"
                )
            # the JAX package would pick aggregation, which has no calibrated
            # rediscretization scale: it stops coarsening here and inverts
            # what remains
            break
        center = (0,) * len(g)
        if center not in A_const.shifts:
            raise ValueError("stencil has no center leg; not SPD-compatible with Jacobi scaling")
        diag = np.asarray(
            [A_const.coeffs[A_const.shifts.index(center)]], np.asarray(A_h.data).dtype
        )
        if np.any(diag <= 0):
            raise ValueError("non-positive diagonal; not SPD-compatible with Jacobi scaling")
        bounds = _const_bounds(A_const) if smoother == "chebyshev" else (0.0, 0.0)
        dt = dtype or np.asarray(A_h.data).dtype
        inv_d = torch.from_numpy(np.asarray(1.0 / diag[0], dtype=dt).reshape(()))
        levels.append(MgLevel(A_const, inv_d, g, bounds, "fw"))
        g_next = transfer.coarse_shape(g)
        A_h = coarse_operator(len(levels), g_next)
        if int(np.prod(g_next)) != A_h.n:
            raise ValueError(f"coarse_operator returned n={A_h.n} for grid {g_next}")
        g = g_next

    if A_h.n > 4 * max_coarse:
        # never silently densify a large remainder
        raise ValueError(
            f"rediscretized coarsening stopped at n={A_h.n} > 4*max_coarse="
            f"{4 * max_coarse} (grid {g}: axes not fw-coarsenable); fix the grid "
            "sizes (2^k - 1 axes) or raise max_coarse explicitly"
        )
    dt = dtype or np.asarray(A_h.data).dtype
    dense = dia_to_dense(A_h)
    coarse_inv = torch.from_numpy(np.linalg.inv(np.asarray(dense, dtype=np.float64)).astype(dt))
    h = MgHierarchy(levels, coarse_inv, smoother, pre, post, omega)
    return h.to(device)


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
    device="cpu",
):
    """Multigrid-preconditioned CG: builds (or reuses) the hierarchy, then
    runs CG with one V-cycle per iteration as M.  Returns
    ``(CGResult, MgHierarchy)`` with a flat ``x``."""
    from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

    policy = policy or ConvergencePolicy()
    h = hierarchy
    if h is None:
        h = build_hierarchy(A, grid, smoother=smoother, pre=pre, post=post, dtype=dtype,
                            coarse_operator=coarse_operator, device=device)
    if not h.levels:
        raise NotImplementedError(
            f"a hierarchy without levels (a pure dense solve) is not ported yet ({_REST_OF_HIERARCHY})"
        )
    dev = h.coarse_inv.device
    tdt = h.coarse_inv.dtype
    b = torch.as_tensor(np.asarray(b), device=dev).to(tdt).reshape(grid)
    if x0 is not None:
        x0 = torch.as_tensor(np.asarray(x0), device=dev).to(tdt).reshape(grid)
    result = cg_solve(h.levels[0].A, b, x0, policy, M=as_preconditioner(h),
                      precise_dot=precise_dot)
    result = CGResult(x=result.x.reshape(-1), iterations=result.iterations,
                      residual=result.residual, converged=result.converged)
    return result, h
