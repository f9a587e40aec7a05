"""Carry state across from the JAX package's containers.

``hierarchy_from_reference`` takes the reference hierarchy as plain numpy
arrays and Python values (the caller does ``np.asarray`` on the JAX side), and
``dia_from_reference`` takes a JAX ``DiaMatrix`` (host numpy or ``jnp`` data),
so both packages can compute with the same state; this module never imports
``jax``.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
    default_device,
)
from conjugategradient_tpu_torch.precond.multigrid import MgHierarchy, MgLevel


def _optional(a):
    return None if a is None else torch.from_numpy(np.array(a))


def hierarchy_from_reference(
    levels: Sequence[Mapping],
    coarse_inv: np.ndarray,
    smoother: str,
    pre: int,
    post: int,
    omega: float,
    device=None,
) -> MgHierarchy:
    """The port's ``MgHierarchy`` from a JAX ``MgHierarchy``'s fields.

    Each entry of ``levels`` maps ``grid``, ``cheb_bounds``, ``transfer``
    (any kind: ``fw``, ``hyb``, ``semi…``, ``agg``) and ``inv_diag`` of one
    level, and its operator in one of three layouts: ``coeffs`` and
    ``shifts`` (a const-stencil level, scalar ``inv_diag``), ``legs`` and
    ``shifts`` (a variable-coefficient stencil level: ``(nlegs, *grid)``
    legs, grid-shaped ``inv_diag``), or ``legs`` and ``offsets`` (a
    ``layout="dia"`` level: ``(ndiags, n)`` data, flat ``inv_diag``).
    Optional keys: ``weight`` (an agg level's weights), ``sa_smooth``
    (default True) and ``mask`` (the rbgs checkerboard).  ``coarse_inv`` is
    the dense coarsest inverse.  ``device=None`` places it on the card when
    there is one.
    """
    out = []
    for lv in levels:
        grid = tuple(int(n) for n in lv["grid"])
        inv_d = np.array(lv["inv_diag"])
        if "offsets" in lv:
            n = int(np.prod(grid))
            A = DiaMatrix(np.array(lv["legs"]), tuple(int(o) for o in lv["offsets"]), (n, n))
            want = (n,)
        else:
            shifts = tuple(tuple(int(s) for s in sh) for sh in lv["shifts"])
            if "legs" in lv:
                A, want = StencilMatrix(np.array(lv["legs"]), shifts, grid), grid
            else:
                A, want = ConstStencilMatrix(tuple(float(c) for c in lv["coeffs"]), shifts, grid), ()
        if inv_d.shape != want:
            raise ValueError(f"inv_diag of shape {inv_d.shape} is not grid {grid}'s "
                             f"{want}, the shape a {type(A).__name__} level takes")
        out.append(
            MgLevel(A, torch.from_numpy(inv_d), grid, tuple(float(v) for v in lv["cheb_bounds"]),
                    str(lv["transfer"]), weight=_optional(lv.get("weight")),
                    mask=_optional(lv.get("mask")), sa_smooth=bool(lv.get("sa_smooth", True)))
        )
    h = MgHierarchy(out, torch.from_numpy(np.array(coarse_inv)), smoother, int(pre),
                    int(post), float(omega))
    return h.to(default_device(device))


def dia_from_reference(A_ref) -> DiaMatrix:
    """The port's host ``DiaMatrix`` from a JAX ``DiaMatrix``: its data as a
    numpy array (``np.asarray`` reads a ``jnp`` array without this module
    importing ``jax``), its offsets and shape as Python ints."""
    return DiaMatrix(
        np.array(np.asarray(A_ref.data)),
        tuple(int(o) for o in A_ref.offsets),
        tuple(int(s) for s in A_ref.shape),
    )
