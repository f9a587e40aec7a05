"""High-level one-call API: ``solve(A, b, method=...)``.

The port of ``conjugategradient_tpu/api.py::solve`` for the ported methods:

- ``method="cg"``      — plain CG on the card, on any container of
  ``core.formats`` (DIA: kernel #4; CSR, ELL, COO, BSR and dense: the plain
  products of ``ops.spmv``)
- ``method="mgcg"``    — multigrid-preconditioned CG (needs ``grid=``): the
  Galerkin hierarchy by default (variable-coefficient levels on kernel #3),
  or the rediscretized one with ``coarse_operator=``
- ``method="refined"`` — mixed-precision iterative refinement to an fp64
  tolerance (``device_residual=True`` keeps the outer loop on the card)
- ``method="oracle"``  — the fp64 numpy CPU oracle, on any host container

``refined`` and ``mgcg`` take a ``DiaMatrix``, as in the JAX package.  An
``(n, k)`` right-hand side routes to the multi-RHS solvers: ``cg``
(``cg_solve_multi``: kernel #5 for DIA, ``ops.spmm`` for the other
containers), ``mgcg`` (``cg_solve_multi`` on the DIA
SpMM with ``as_multi_preconditioner`` over the Galerkin hierarchy) and
``refined`` (``refined_solve_multi``, with or without ``grid``).
Every other method of the JAX facade raises ``NotImplementedError`` naming
the ROADMAP item that ports it; nothing is rerouted.

``device`` says where the solve runs; ``None`` takes the card when there is
one, as the JAX package takes its default backend.  Host numpy arrays or
torch tensors on any device in (as the JAX facade takes device arrays),
results with ``.x``, ``.iterations``, ``.residual`` and ``.converged`` out.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix, default_device, place
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

_PRECONDITIONERS = "ROADMAP queue 1: preconditioners"
_SOLVER_FAMILIES = "ROADMAP queue 1: solver families"
_PARALLEL = "ROADMAP queue 1: parallel"
_UNPORTED = {
    **{m: _SOLVER_FAMILIES for m in (
        "bicgstab", "gmres", "fgmres", "minres", "idr", "lsmr", "cgnr", "chebyshev",
        "cacg", "deflated_cg", "native", "auto",
    )},
    "cheb_cg": _PRECONDITIONERS,
    "sharded_cg": _PARALLEL,
}
_PREFIXES = ("jacobi_", "bjacobi_", "amg_", "mg_")


def _place_matrix(A, dtype, device):
    """Any container on ``device`` at ``dtype``, as the JAX facade calls
    ``device_put(dtype)`` on any container that has one; a stencil of
    constants or a callable as it is."""
    return A.device_put(dtype, device) if hasattr(A, "device_put") else A


def _refuse(method: str):
    """Raise ``NotImplementedError`` for a JAX-facade method the port does
    not have yet, or ``ValueError`` for an unknown one."""
    if method in _UNPORTED:
        raise NotImplementedError(f"method={method!r} is not ported yet ({_UNPORTED[method]})")
    if method.startswith(_PREFIXES):
        raise NotImplementedError(
            f"method={method!r}: preconditioner prefixes are not ported yet ({_PRECONDITIONERS})"
        )
    raise ValueError(f"unknown method {method!r}")


def solve(
    A,
    b,
    x0=None,
    method: str = "cg",
    tol: float = 1e-8,
    norm: str = "l2",
    min_iteration: int = 0,
    max_iteration: Optional[int] = None,
    grid: Optional[Tuple[int, ...]] = None,
    dtype=None,
    device=None,
    **kw,
):
    """Solve A x = b (or A X = B for an (n, k) ``b``)."""
    policy = ConvergencePolicy(
        tol=tol, norm=norm, min_iteration=min_iteration, max_iteration=max_iteration
    )
    if "mesh" in kw or "axes" in kw:
        raise NotImplementedError(f"mesh-distributed solves are not ported yet ({_PARALLEL})")
    device = default_device(device)
    if np.ndim(b) == 2:
        return _solve_multi(A, b, x0, method, policy, grid, dtype, device, **kw)
    if method == "oracle":
        return oracle.cg(
            A, b, x0, tol=tol, norm=norm, min_iteration=min_iteration,
            max_iteration=max_iteration, raise_on_divergence=False,
        )
    if method == "refined":
        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        from conjugategradient_tpu_torch.solvers.refine import refined_solve

        return refined_solve(A, b, x0, tol=tol, norm=norm, grid=grid, device=device, **kw)
    if method == "mgcg":
        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        from conjugategradient_tpu_torch.precond.multigrid import mgcg_solve

        res, _ = mgcg_solve(A, b, grid, x0=x0, policy=policy, dtype=dtype, device=device, **kw)
        return res
    if method != "cg":
        _refuse(method)
    from conjugategradient_tpu_torch.solvers.cg import cg_solve

    b_dev = place(b, dtype, device)
    x0_dev = None if x0 is None else place(x0, dtype, device)
    A_dev = _place_matrix(A, dtype, device)
    return cg_solve(A_dev, b_dev, x0_dev, policy, **kw)


def _solve_multi(A, B, X0, method, policy, grid, dtype, device, **kw):
    """Multi-RHS routing: ``cg``, ``mgcg`` and ``refined`` over (n, k)
    blocks."""
    if method == "refined":
        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        from conjugategradient_tpu_torch.solvers.refine import refined_solve_multi

        return refined_solve_multi(A, B, X0, tol=policy.tol, norm=policy.norm, grid=grid,
                                   device=device, **kw)
    if method not in ("cg", "mgcg"):
        _refuse(method)
    from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner, cg_solve_multi

    B_dev = place(B, dtype, device)
    X0_dev = None if X0 is None else place(X0, dtype, device)
    M = None
    if method == "mgcg":
        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy

        np_dtype = torch.empty(0, dtype=B_dev.dtype).numpy().dtype
        M = as_multi_preconditioner(build_hierarchy(A, grid, dtype=np_dtype, device=device))
    A_dev = _place_matrix(A, dtype, device)
    return cg_solve_multi(A_dev, B_dev, X0_dev, policy, M=M, **kw)


def _to_csr(A) -> formats.CsrMatrix:
    return formats._any_to_csr(A)


def _diagonal(A):
    return formats.matrix_diagonal(A)
