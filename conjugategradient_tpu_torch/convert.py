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

from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, DiaMatrix
from conjugategradient_tpu_torch.precond.multigrid import MgHierarchy, MgLevel


def hierarchy_from_reference(
    levels: Sequence[Mapping],
    coarse_inv: np.ndarray,
    smoother: str,
    pre: int,
    post: int,
    omega: float,
    device="cpu",
) -> MgHierarchy:
    """The port's ``MgHierarchy`` from a JAX ``MgHierarchy``'s fields.

    Each entry of ``levels`` maps ``coeffs``, ``shifts``, ``grid``,
    ``cheb_bounds``, ``transfer`` and ``inv_diag`` (a scalar numpy array) of
    one const-stencil level; ``coarse_inv`` is the dense coarsest inverse.
    Only the slice's levels are carried: fw transfers and scalar
    ``inv_diag``.
    """
    out = []
    for lv in levels:
        if lv["transfer"] != "fw":
            raise NotImplementedError(
                f"{lv['transfer']!r} transfers are not ported yet "
                "(ROADMAP queue 1 item 9 (the rest of the hierarchy))"
            )
        inv_d = np.asarray(lv["inv_diag"])
        if inv_d.ndim != 0:
            raise NotImplementedError(
                "grid-shaped inv_diag (variable-coefficient levels) is not ported yet "
                "(ROADMAP queue 2 kernel #3)"
            )
        A = ConstStencilMatrix(
            tuple(float(c) for c in lv["coeffs"]),
            tuple(tuple(int(s) for s in sh) for sh in lv["shifts"]),
            tuple(int(n) for n in lv["grid"]),
        )
        out.append(
            MgLevel(A, torch.from_numpy(inv_d.copy()), A.grid,
                    tuple(float(v) for v in lv["cheb_bounds"]), "fw")
        )
    h = MgHierarchy(out, torch.from_numpy(np.array(coarse_inv)), smoother, int(pre),
                    int(post), float(omega))
    return h.to(device)


def dia_from_reference(A_ref) -> DiaMatrix:
    """The port's host ``DiaMatrix`` from a JAX ``DiaMatrix``: its data as a
    numpy array (``np.asarray`` reads a ``jnp`` array without this module
    importing ``jax``), its offsets and shape as Python ints."""
    return DiaMatrix(
        np.array(np.asarray(A_ref.data)),
        tuple(int(o) for o in A_ref.offsets),
        tuple(int(s) for s in A_ref.shape),
    )
