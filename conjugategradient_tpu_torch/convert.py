"""Carry state across from the JAX package's containers.

``hierarchy_from_reference`` takes the reference hierarchy as plain numpy
arrays and Python values (the caller does ``np.asarray`` on the JAX side), and
``matrix_from_reference`` takes any JAX container (host numpy or ``jnp``
data) by its class name and fields, so both packages can compute with the
same state; this module never imports ``jax``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np
import torch

from conjugategradient_tpu_torch.core import formats
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


#: how each static field of a container reads back as Python values
_STATIC = {
    "offsets": lambda v: tuple(int(o) for o in v),
    "shape": lambda v: tuple(int(d) for d in v),
    "grid": lambda v: tuple(int(d) for d in v),
    "shifts": lambda v: tuple(tuple(int(d) for d in s) for s in v),
    "coeffs": lambda v: tuple(float(c) for c in v),
}


def matrix_from_reference(obj):
    """The port's host container of the same class name as a JAX container
    (``DiaMatrix``, ``EllMatrix``, ``CsrMatrix``, ``CooMatrix``,
    ``BsrMatrix``, ``DenseMatrix``, ``StencilMatrix``,
    ``ConstStencilMatrix``): each array field a numpy copy (``np.asarray``
    reads a ``jnp`` array without this module importing ``jax``), each
    static field Python values."""
    cls = {c.__name__: c for c in formats.CONTAINERS}.get(type(obj).__name__)
    if cls is None:
        raise TypeError(f"no port container for {type(obj).__name__}")
    fields = {}
    for f in dataclasses.fields(cls):
        v = getattr(obj, f.name)
        fields[f.name] = _STATIC[f.name](v) if f.name in _STATIC else np.array(np.asarray(v))
    return cls(**fields)


def dia_from_reference(A_ref) -> DiaMatrix:
    """The port's host ``DiaMatrix`` from a JAX ``DiaMatrix``
    (``matrix_from_reference``)."""
    if type(A_ref).__name__ != "DiaMatrix":
        raise TypeError(f"not a DiaMatrix: {type(A_ref).__name__}")
    return matrix_from_reference(A_ref)
