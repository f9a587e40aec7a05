"""Carry state across from the JAX package's containers.

``hierarchy_from_reference`` takes the reference hierarchy as plain numpy
arrays and Python values (the caller does ``np.asarray`` on the JAX side),
``matrix_from_reference`` takes any JAX container (host numpy or ``jnp``
data) by its class name and fields, and ``amg_hierarchy_from_reference``
takes a JAX ``AmgHierarchy`` object the same way,
``idr_shadow_from_reference`` takes the JAX package's IDR(s) shadow draw
as a numpy array, ``lobpcg_draws_from_reference`` its LOBPCG start block
and first search directions, and ``deflation_from_reference`` a JAX
``Deflation``'s arrays, so both packages can compute with the same state; this module
never imports ``jax``.
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
from conjugategradient_tpu_torch.precond.amg import AmgHierarchy, AmgLevel
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


def idr_shadow_from_reference(draw, device=None) -> torch.Tensor:
    """The ``(n, s)`` shadow draw of an IDR(s) solve as a tensor on
    ``device`` (``None``: the card when there is one), for
    ``solvers.idr``'s ``shadow=``: ``draw`` is the JAX package's
    ``jax.random.normal(PRNGKey(seed), (n, s), dtype)`` read as numpy, before
    its columns are normalised.  The solver casts it to the solve's dtype
    and normalises it as the JAX package does."""
    a = np.array(np.asarray(draw))
    if a.ndim != 2:
        raise ValueError(f"the shadow draw must be (n, s), got shape {a.shape}")
    return torch.from_numpy(a).to(default_device(device))


def lobpcg_draws_from_reference(X0, P0, device=None):
    """``(X0, P0)`` of a LOBPCG solve as tensors on ``device`` (``None``:
    the card when there is one), for ``solvers.lobpcg``'s ``X0=`` and
    ``P0=``: the JAX package's ``jax.random.normal(PRNGKey(seed), (n, k),
    dtype)`` and ``jax.random.normal(PRNGKey(seed + 1), (n, k), dtype)``
    read as numpy.  The solver casts them to the solve's dtype."""
    out = []
    for name, draw in (("X0", X0), ("P0", P0)):
        a = np.array(np.asarray(draw))
        if a.ndim != 2:
            raise ValueError(f"{name} must be (n, k), got shape {a.shape}")
        out.append(torch.from_numpy(a).to(default_device(device)))
    if out[0].shape != out[1].shape:
        raise ValueError(f"X0 {tuple(out[0].shape)} and P0 {tuple(out[1].shape)} differ in shape")
    return tuple(out)


def deflation_from_reference(defl, device=None):
    """The port's ``solvers.deflation.Deflation`` from a JAX ``Deflation``:
    its ``W``, ``AW``, ``chol_E`` and ``scale`` read as numpy arrays (dtype
    kept) and placed on ``device`` (``None``: the card when there is one),
    so ``deflated_cg_solve`` runs on the JAX package's own basis."""
    from conjugategradient_tpu_torch.solvers.deflation import Deflation

    dev = default_device(device)
    put = lambda a: torch.from_numpy(np.array(np.asarray(a))).to(dev)
    return Deflation(put(defl.W), put(defl.AW), put(defl.chol_E), put(defl.scale))


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


def _on_cpu(A):
    """A host container as the CPU tensors a level holds (a const stencil
    as it is)."""
    return A if isinstance(A, ConstStencilMatrix) else A.device_put(device="cpu")


def amg_hierarchy_from_reference(h_ref, device=None) -> AmgHierarchy:
    """The port's ``AmgHierarchy`` from a JAX ``AmgHierarchy``: each
    level's operator, ``P`` and ``R`` through ``matrix_from_reference``, its
    arrays (``inv_diag``, ``agg``, ``w``, ``coarse_inv``) read as numpy and
    its static fields as Python values.  ``device=None`` places it on the
    card when there is one."""
    levels = []
    for l in h_ref.levels:
        levels.append(AmgLevel(
            _on_cpu(matrix_from_reference(l.A)), _on_cpu(matrix_from_reference(l.P)),
            _on_cpu(matrix_from_reference(l.R)), torch.from_numpy(np.array(l.inv_diag)),
            tuple(float(v) for v in l.cheb_bounds), agg=_optional(l.agg), w=_optional(l.w),
            nc=int(l.nc), sa_c=float(l.sa_c), blk=int(l.blk),
            blk_nd=None if l.blk_nd is None else tuple(tuple(int(v) for v in t)
                                                       for t in l.blk_nd),
        ))
    h = AmgHierarchy(levels, torch.from_numpy(np.array(h_ref.coarse_inv)), str(h_ref.smoother),
                     int(h_ref.pre), int(h_ref.post), float(h_ref.omega))
    return h.to(default_device(device))
