"""High-level one-call API: ``solve(A, b, method=...)`` and ``eigs(A, k)``.

The port of ``conjugategradient_tpu/api.py``: ``eigs`` (the eigensolver
facade, its own docstring) and ``solve`` for the ported methods:

- ``method="cg"``      — plain CG on the card, on any container of
  ``core.formats`` (DIA: kernel #4; CSR, ELL, COO, BSR and dense: the plain
  products of ``ops.spmv``)
- ``method="mgcg"``    — multigrid-preconditioned CG (needs ``grid=``): the
  Galerkin hierarchy by default (variable-coefficient levels on kernel #3),
  or the rediscretized one with ``coarse_operator=``
- ``method="refined"`` — mixed-precision iterative refinement to an fp64
  tolerance (``device_residual=True`` keeps the outer loop on the card;
  ``inner="bicgstab"`` for nonsymmetric systems)
- ``method="oracle"``  — the fp64 numpy CPU oracle, on any host container
- ``method="native"``  — the OpenMP C++ CG of the host kit (``native.cg``)
  on the matrix as CSR, fp64 on the CPU by definition: host numpy out, as
  the JAX facade's
- ``method="bicgstab"`` — nonsymmetric systems, short recurrence
  (``solvers.bicgstab``)
- ``method="gmres"``   — nonsymmetric systems, restarted GMRES
  (``restart=``, default 32; ``solvers.gmres``)
- ``method="fgmres"``  — flexible GMRES: ``inner="bicgstab"|"cg"|
  "chebyshev"`` (and ``inner_iterations=``, default 8) makes a fixed-budget
  inner Krylov solve the preconditioner; a prefix then preconditions the
  inner solve (``method="mg_fgmres", inner="bicgstab"``)
- ``method="minres"``  — symmetric indefinite systems (Helmholtz;
  ``solvers.minres``)
- ``method="idr"``     — IDR(s) for nonsymmetric systems (``s=``, default 4;
  ``shadow=`` takes the ``(n, s)`` shadow draw, ``solvers.idr``)
- ``method="chebyshev"`` — the dot-free Chebyshev iteration for SPD systems
  (``bounds=(lo, hi)``, by host Lanczos when not given; ``check_every=``);
  no prefix
- ``method="cheb_cg"`` — Chebyshev-polynomial PCG (``degree=``, default 3;
  bounds by host Lanczos)
- the prefixes ``jacobi_`` (point Jacobi), ``bjacobi_`` (block Jacobi,
  ``block_size=``, default 8), ``mg_`` (the geometric V-cycle: ``grid=`` and
  a ``DiaMatrix``, ``coarse_operator=`` rediscretizes) and ``amg_``
  (smoothed-aggregation AMG, no grid: ``theta=``, ``near_null=``,
  ``max_coarse=``, ``max_levels=``; Jacobi smoothing on the nonsymmetric
  bases) on ``cg``, ``bicgstab``, ``gmres``, ``fgmres``, ``minres`` and
  ``idr``
- ``method="cgnr"``    — CG on the normal equations (any nonsingular A;
  constant memory, kappa squared: the nonsymmetric fallback;
  ``solvers.cgnr``)
- ``method="lsmr"``    — least squares ``min ||A x - b||`` for a
  rectangular (over- or underdetermined) or square A, with an optional
  Tikhonov ``damp=`` (``solvers.lsmr``)
- ``method="cacg"`` / ``"jacobi_cacg"`` — s-step CG (``s=``, default 4):
  two host reads per s iterations (``solvers.cacg``); ``jacobi_`` folds a
  symmetric diagonal scaling into a ``DiaMatrix`` (the only preconditioning
  the shift identity admits) and monitors the scaled system; any other
  prefix is a ``ValueError``
- ``method="deflated_cg"`` — def-CG over a Lanczos-probed deflation space
  (``k=``, ``m=``, or a prebuilt ``deflation=`` for a solve sequence;
  ``solvers.deflation``)
- ``method="auto"``    — LSMR for a rectangular A; otherwise probe the
  matrix on the host (symmetry, then definiteness by a positive diagonal
  and a 120-step Lanczos bound) and pick: CG (``mgcg`` with a grid) for
  SPD, MINRES for symmetric indefinite, IDR(4) (``mg_bicgstab`` with a
  grid) for nonsymmetric; a stalled solve warns with the likely cure

``refined`` and ``mgcg`` take a ``DiaMatrix``, as in the JAX package.  An
``(n, k)`` right-hand side routes to the multi-RHS solvers: ``cg``
(``cg_solve_multi``: kernel #5 for DIA, ``ops.spmm`` for the other
containers), ``jacobi_cg``, ``bjacobi_cg`` and ``amg_cg``, ``mgcg``
(``as_multi_preconditioner`` over the Galerkin hierarchy), ``refined``
(``refined_solve_multi``), and the BiCGStab family ``bicgstab``,
``jacobi_bicgstab``, ``bjacobi_bicgstab``, ``mg_bicgstab`` (Jacobi
smoothing) and ``amg_bicgstab`` (``bicgstab_solve_multi``); ``auto`` takes
``bicgstab`` where it would take ``idr``; ``cgnr``, ``lsmr``, ``cacg`` and
``deflated_cg`` take no block, nor do ``oracle`` and ``native``
(``ValueError``, as in the JAX facade).

``mesh=`` (a ``parallel.mesh.Mesh``; several shards may share one card)
runs the row-block-sharded solvers of ``parallel``, as the JAX facade
does: ``cg`` and ``method="sharded_cg"`` on a ``DiaMatrix`` take
``parallel.sharded_cg_solve`` (kernel #4 on every shard; ``variant=``
``"cg1"``, ``"pipelined"``, ``"cacg"``), on a CSR or ELL matrix
``parallel.sharded_cg_solve_general`` (exact halos); ``jacobi_cg`` adds the
shard-local point Jacobi; ``cacg`` and ``jacobi_cacg`` run the sharded
s-step CG; ``mgcg`` takes ``parallel.gspmd_mgcg_solve`` (the sharded
V-cycle on kernel #3 where the grid divides the mesh, the single-device
MGCG on the mesh's first device where it does not); ``refined`` with
``mesh=`` or ``axes=`` takes ``parallel.gspmd.gspmd_refined_solve`` (the
fp64 outer residual on kernel #4 per shard; ``grid=`` required).  (n, k)
blocks with ``mesh=``: ``cg``, ``sharded_cg`` and ``bicgstab`` take
``parallel.shard_multi.sharded_cg_multi_solve`` (kernel #5 per shard),
``mgcg`` ``shard_multi_mgcg_solve``, any other method ``ValueError``.
The nonsymmetric bases ``bicgstab``, ``gmres``, ``fgmres``, ``minres``,
``chebyshev`` and ``idr`` with ``mesh=`` take
``parallel.shard_nonsym.sharded_nonsym_solve`` (kernel #4 a shard;
BiCGStab's two collectives an iteration; Chebyshev's extended-region block
loop, its bounds by host Lanczos when not given), ``jacobi_`` and
``bjacobi_`` as shard-local preconditioners (``block_size`` must divide the
shard length), ``mg_bicgstab``/``gmres``/``fgmres``/``idr``
``parallel.gspmd.gspmd_mg_nonsym_solve`` (``grid=`` and a ``DiaMatrix``:
the sharded V-cycle on kernel #3 where the grid divides the mesh, the
single-device solve on its first device where it does not); ``fgmres``
refuses ``inner=``; ``lsmr`` takes ``sharded_lsmr_solve`` (a square-banded
``DiaMatrix``, A^T a second row-sharded DIA); ``amg_cg``, ``amg_bicgstab``,
``amg_gmres``, ``amg_fgmres`` and ``amg_minres``
``parallel.shard_amg.sharded_amg_solve`` (any container; the sharded levels'
products on cuSPARSE a shard, the replicated tail on the hierarchy's
kernels).  ``sharded_cg`` without a mesh spans every CUDA device (the
solve's device when that is not the card).  ``axes=`` takes one mesh axis
(``refined``, ``mgcg``, ``mg_*``).  A method with no sharded route raises
``TypeError``; 2-D ``axes=`` and ``eigs(mesh=)`` raise
``NotImplementedError`` naming ROADMAP's parallel item; nothing is
rerouted.

``device`` says where the solve runs; ``None`` takes the card when there is
one, as the JAX package takes its default backend.  Host numpy arrays or
torch tensors on any device in (as the JAX facade takes device arrays),
results with ``.x``, ``.iterations``, ``.residual`` and ``.converged`` out.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import torch

from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix, default_device, place
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

_PREFIXES = ("jacobi_", "bjacobi_", "amg_", "mg_")
#: the bases a prefix may precondition
_KRYLOV = ("cg", "bicgstab", "gmres", "fgmres", "minres", "idr")
#: the nonsymmetric bases: an amg_ prefix smooths by Jacobi on them
_NONSYM = ("bicgstab", "gmres", "fgmres", "idr")
_MULTI = ("cg", "mgcg", "jacobi_cg", "bjacobi_cg", "amg_cg", "bicgstab", "jacobi_bicgstab",
          "bjacobi_bicgstab", "mg_bicgstab", "amg_bicgstab")
_AMG_SETUP = ("theta", "near_null", "max_coarse", "max_levels")
#: the single-RHS methods outside the Krylov bases (no prefix but cacg's
#: jacobi_)
_OTHER = ("cgnr", "lsmr", "cacg", "deflated_cg")
#: the bases the JAX facade's mesh route sends to the sharded nonsymmetric loops
_NONSYM_MESH = ("bicgstab", "gmres", "fgmres", "minres", "idr")
#: the fp64 host solvers: no block, no prefix
_HOST = ("oracle", "native")
#: the row count above which ``eigs(method="auto")`` runs no probe
_PROBE_CAP = 4_000_000


def _place_matrix(A, dtype, device):
    """Any container on ``device`` at ``dtype``, as the JAX facade calls
    ``device_put(dtype)`` on any container that has one; a stencil of
    constants or a callable as it is."""
    return A.device_put(dtype, device) if hasattr(A, "device_put") else A


def _split_prefix(method: str):
    """(prefix, base) of a method name: ``"amg_cg"`` -> ``("amg", "cg")``,
    ``"cg"`` -> ``(None, "cg")``."""
    for p in _PREFIXES:
        if method.startswith(p):
            return p[:-1], method[len(p):]
    return None, method


def _refuse(method: str):
    """Raise ``ValueError`` for a prefix on ``chebyshev`` (as the JAX
    facade does) or an unknown method."""
    prefix, base = _split_prefix(method)
    if prefix is not None and base == "chebyshev":
        raise ValueError(
            "chebyshev takes no preconditioner prefix (fold scaling into "
            "the operator and its bounds instead)"
        )
    raise ValueError(f"unknown method {base!r}")


def _preconditioner(A, prefix: str, base: str, dtype: torch.dtype, device, grid, kw,
                    multi: bool = False):
    """The M of a prefixed method at the solve's dtype on ``device``,
    popping the keywords it takes from ``kw``; ``(n, k)`` blocks with
    ``multi``."""
    if prefix == "jacobi":
        inv = torch.from_numpy(1.0 / _diagonal(A)).to(device=device, dtype=dtype)
        return lambda r: (inv if r.ndim == 1 else inv[:, None]) * r
    if prefix == "bjacobi":
        from conjugategradient_tpu_torch.precond.block_jacobi import block_jacobi_preconditioner

        return block_jacobi_preconditioner(A, int(kw.pop("block_size", 8)), dtype=dtype,
                                           device=device)
    if prefix == "amg":
        from conjugategradient_tpu_torch.precond.amg import amg_preconditioner, build_amg_hierarchy

        setup_kw = {k: kw.pop(k) for k in _AMG_SETUP if k in kw}
        if base in _NONSYM:
            # the coarse correction must see the convection, and Chebyshev
            # smoothing assumes a real positive D^-1 A spectrum
            setup_kw.setdefault("smoother", "jacobi")
        return amg_preconditioner(build_amg_hierarchy(A, dtype=dtype, device=device, **setup_kw))
    # the geometric V-cycle: the JAX facade's mg_ prefix
    if grid is None:
        raise ValueError(f"mg_{base} requires grid=")
    if not isinstance(A, DiaMatrix):
        raise TypeError(f"mg_{base} requires a DiaMatrix")
    from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner, build_hierarchy
    from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner

    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    # coarse_operator= rediscretizes: required on convection-dominated
    # operators past ~127^2, whose Galerkin coarse operators amplify
    setup = dict(dtype=np_dtype, coarse_operator=kw.pop("coarse_operator", None), device=device)
    if multi:
        h = build_hierarchy(A, grid, smoother=kw.pop("smoother", "jacobi"), **setup)
        return as_multi_preconditioner(h)
    return as_preconditioner(build_hierarchy(A, grid, **setup))


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
    if "axes" in kw and not _takes_axes(method, b, kw):
        if method not in _HOST:  # the JAX facade's host solves ignore it
            raise TypeError(f"method={method!r} got an unexpected keyword argument 'axes': the "
                            "GSPMD partitions are refined's, and mgcg's and mg_*'s with mesh=")
        kw.pop("axes")
    device = default_device(device)
    if method == "auto":
        return _solve_auto(A, b, x0, policy, grid, dtype, device, kw)
    if np.ndim(b) == 2:
        return _solve_multi(A, b, x0, method, policy, grid, dtype, device, **kw)
    if "mesh" in kw or "axes" in kw or method == "sharded_cg":
        return _solve_mesh(A, b, x0, method, policy, grid, dtype, device, kw)
    if method == "oracle":
        return oracle.cg(
            A, b, x0, tol=tol, norm=norm, min_iteration=min_iteration,
            max_iteration=max_iteration, raise_on_divergence=False,
        )
    if method == "native":
        from conjugategradient_tpu_torch import native

        return native.cg(
            _to_csr(formats.to_host(A)), formats.host_f64(b),
            None if x0 is None else formats.host_f64(x0), tol=tol, norm=norm,
            min_iteration=min_iteration, max_iteration=max_iteration, raise_on_divergence=False,
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
    prefix, base = _split_prefix(method)
    if base == "cacg":
        return _solve_cacg(A, b, x0, prefix, policy, dtype, device, kw)
    if method in _OTHER:
        return _solve_other(method, A, b, x0, policy, dtype, device, kw)
    if method != "cheb_cg" and (base not in _KRYLOV + ("chebyshev",)
                                or (base == "chebyshev" and prefix is not None)):
        _refuse(method)

    b_dev = place(b, dtype, device)
    x0_dev = None if x0 is None else place(x0, dtype, device)
    A_dev = _place_matrix(A, dtype, device)
    M = None
    if prefix is not None:
        M = _preconditioner(A, prefix, base, b_dev.dtype, device, grid, kw)
    elif method == "cheb_cg":
        from conjugategradient_tpu_torch.precond.smoothers import chebyshev_preconditioner_for

        # the placed matrix, M at b's dtype: one device copy
        M, _ = chebyshev_preconditioner_for(A, degree=int(kw.pop("degree", 3)), A_dev=A_dev,
                                            dtype=b_dev.dtype)
        base = "cg"
    return _run(base, A, A_dev, b_dev, x0_dev, policy, M, kw)


def _takes_axes(method: str, b, kw) -> bool:
    """Whether ``method`` takes ``axes=`` as the JAX facade routes it: the
    mesh-partitioned refinement (with or without ``mesh=``), and with
    ``mesh=`` the GSPMD MGCG and multigrid-preconditioned nonsymmetric
    carriers, on one right-hand side."""
    if method == "refined":
        return True
    prefix, base = _split_prefix(method)
    return ("mesh" in kw and np.ndim(b) == 1
            and (method == "mgcg" or (prefix == "mg" and base in _NONSYM_MESH)))


def _jacobi_M_local(r, aux):
    """Shard-local point Jacobi, the ``M_local`` of ``jacobi_cg`` and the
    nonsymmetric ``jacobi_`` bases with ``mesh=``: ``aux`` is the shard's
    rows of 1/diag(A)."""
    return aux * r


def _solve_mesh(A, b, x0, method, policy, grid, dtype, device, kw):
    """The ``mesh=`` routes (and ``sharded_cg`` without one): ``cg`` and
    ``sharded_cg`` (DIA: ``sharded_cg_solve``; CSR/ELL:
    ``sharded_cg_solve_general``), ``jacobi_cg`` (a shard-local Jacobi
    ``M_local``), ``cacg`` and ``jacobi_cacg`` (``variant="cacg"``),
    ``mgcg`` (``gspmd_mgcg_solve``), ``refined`` (``gspmd_refined_solve``,
    with ``axes=`` too), the ``amg_`` prefix (``sharded_amg_solve``), the
    nonsymmetric bases (``_solve_mesh_nonsym``) and ``lsmr``
    (``sharded_lsmr_solve``); any other method raises ``TypeError``."""
    from conjugategradient_tpu_torch.parallel import shard_amg, shard_nonsym
    from conjugategradient_tpu_torch.parallel.mesh import make_mesh

    mesh = kw.pop("mesh", None)
    if mesh is None:
        mesh = make_mesh(devices=None if device.type == "cuda" else [device])
    if method == "refined":
        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        if grid is None:
            raise TypeError("refined solve over a mesh requires grid=")
        from conjugategradient_tpu_torch.parallel.gspmd import gspmd_refined_solve

        return gspmd_refined_solve(A, b, grid, mesh=mesh, x0=x0, tol=policy.tol,
                                   norm=policy.norm, **kw)
    if method == "mgcg":
        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        from conjugategradient_tpu_torch.core.generators import LinearSystem
        from conjugategradient_tpu_torch.parallel.gspmd import gspmd_mgcg_solve

        system = LinearSystem(A, b, np.zeros(A.n) if x0 is None else x0)
        return gspmd_mgcg_solve(system, grid, mesh=mesh, policy=policy, dtype=dtype, **kw)
    prefix, base = _split_prefix(method)
    if base == "chebyshev" and prefix is not None:
        _refuse(method)
    if base == "cacg":
        return _solve_cacg(A, b, x0, prefix, policy, dtype, device, kw, mesh=mesh)
    if prefix == "amg":
        # row-sharded SA levels with exact-hop ring gathers (the all-gather
        # window where those cover most of the ring) and the replicated
        # tail, the cycle the M of the sharded Krylov loops
        if base not in shard_amg.METHODS:
            raise ValueError(f"{method} with mesh= is not supported")
        return shard_amg.sharded_amg_solve(A, b, x0, policy, method=base, mesh=mesh, dtype=dtype,
                                           **kw)[0]
    if base in shard_nonsym.METHODS:
        return _solve_mesh_nonsym(A, b, x0, prefix, base, policy, grid, dtype, mesh, kw)
    if method == "lsmr":
        # A and A^T on kernel #4 a shard, two scalar psums an iteration;
        # a rectangular system must be square-padded by the caller (zero
        # rows and columns are neutral in LSMR)
        if not isinstance(A, DiaMatrix):
            raise TypeError(
                "lsmr with mesh= needs a square-banded DiaMatrix (rectangular input: embed it "
                "in a square band — zero rows/columns are neutral in LSMR — or solve unsharded)")
        return shard_nonsym.sharded_lsmr_solve(A, b, x0, policy, mesh=mesh, dtype=dtype, **kw)
    if method == "jacobi_cg":
        kw.setdefault("M_local", _jacobi_M_local)
        kw.setdefault("M_aux", 1.0 / _diagonal(A))
    elif method not in ("cg", "sharded_cg"):
        # as the JAX facade, whose single-device solvers take no mesh keyword
        raise TypeError(f"method={method!r} has no sharded route: it takes no mesh=")
    if isinstance(A, DiaMatrix):
        from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_solve

        return sharded_cg_solve(A, b, x0, policy, mesh=mesh, dtype=dtype, **kw)
    if isinstance(A, (formats.CsrMatrix, formats.EllMatrix)):
        from conjugategradient_tpu_torch.parallel.sharded_general import sharded_cg_solve_general

        return sharded_cg_solve_general(formats.to_host(A), b, x0, policy, mesh=mesh,
                                        dtype=dtype, **kw)
    raise TypeError("sharded_cg requires a DiaMatrix, CsrMatrix or EllMatrix")


def _solve_mesh_nonsym(A, b, x0, prefix, base, policy, grid, dtype, mesh, kw):
    """The row-block-sharded nonsymmetric bases (``parallel.shard_nonsym``)
    with the JAX facade's preconditioning: ``jacobi_`` and ``bjacobi_`` as
    shard-local ``M_local`` (block Jacobi only where ``block_size`` divides
    the shard length), ``mg_`` through ``gspmd_mg_nonsym_solve`` (the
    sharded V-cycle where the grid shards, the single-device solve on the
    mesh's first device where it does not), and ``chebyshev``'s bounds by
    host Lanczos when not given."""
    from conjugategradient_tpu_torch.parallel.shard_nonsym import sharded_nonsym_solve

    if prefix == "mg":
        from conjugategradient_tpu_torch.parallel.gspmd import MG_NONSYM, gspmd_mg_nonsym_solve

        if base not in MG_NONSYM:
            raise ValueError(f"mg_{base} with mesh= is not supported")
        if grid is None:
            raise ValueError(f"mg_{base} requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError(f"mg_{base} requires a DiaMatrix")
        return gspmd_mg_nonsym_solve(A, b, grid, mesh=mesh, policy=policy, method=base, x0=x0,
                                     dtype=dtype, **kw)
    if base == "fgmres" and "inner" in kw:
        raise ValueError(
            "fgmres with mesh= does not take inner=: a global inner Krylov solve needs its own "
            "collectives; pass a shard-local fixed-budget M_local to "
            "parallel.shard_nonsym.sharded_nonsym_solve instead")
    if prefix == "jacobi":
        kw.update(M_local=_jacobi_M_local, M_aux=1.0 / _diagonal(A))
    elif prefix == "bjacobi":
        from conjugategradient_tpu_torch.precond.block_jacobi import (
            block_jacobi_aux,
            block_jacobi_M_local,
        )

        bs = int(kw.pop("block_size", 8))
        n_local = A.n // mesh.shape[kw.get("axis", "x")]
        if n_local % bs:
            raise ValueError(
                f"bjacobi with mesh= needs block_size ({bs}) to divide the shard length "
                f"({n_local}) so blocks stay shard-local")
        kw.update(M_local=block_jacobi_M_local, M_aux=block_jacobi_aux(formats.to_host(A), bs))
    if base == "chebyshev" and "bounds" not in kw:
        from conjugategradient_tpu_torch.solvers.cheby import estimate_bounds

        kw["bounds"] = estimate_bounds(A)
    return sharded_nonsym_solve(A, b, x0, policy, method=base, mesh=mesh, dtype=dtype, **kw)


def _solve_cacg(A, b, x0, prefix, policy, dtype, device, kw, mesh=None):
    """``cacg`` and ``jacobi_cacg``: ``D^-1/2 A D^-1/2 y = D^-1/2 b`` and
    ``x = D^-1/2 y`` for the latter, its residual and tolerance those of
    the scaled system, as in the JAX facade; with ``mesh`` the sharded
    s-step CG (``sharded_cg_solve(variant="cacg")``, a ``DiaMatrix``)."""
    from conjugategradient_tpu_torch.solvers.cacg import cacg_solve

    if prefix not in (None, "jacobi"):
        raise ValueError(
            f"{prefix}_cacg: cacg supports only the jacobi_ prefix (symmetric diagonal "
            "scaling — a general M breaks the s-step shift identity; use cg there)"
        )
    A_c, dis, b_c, x0_c = A, None, b, x0
    if prefix == "jacobi":
        if not isinstance(A, DiaMatrix):
            raise TypeError("jacobi_cacg requires a DiaMatrix")
        A_c, dis = formats.jacobi_scaled_dia(formats.to_host(A))
        b_c = formats.host_f64(b) * dis
        x0_c = None if x0 is None else formats.host_f64(x0) / dis
    if mesh is not None:
        if not isinstance(A_c, DiaMatrix):
            raise TypeError("cacg with mesh= requires a DiaMatrix (the matrix-powers halo "
                            "kernel is banded DIA); convert or use method='sharded_cg'")
        from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_solve

        res = sharded_cg_solve(A_c, b_c, x0_c, policy, mesh=mesh, dtype=dtype, variant="cacg",
                               **kw)
        if dis is not None:
            res = dataclasses.replace(res, x=res.x * torch.from_numpy(dis).to(res.x))
        return res
    b_dev = place(b_c, dtype, device)
    res = cacg_solve(_place_matrix(A_c, dtype, device), b_dev,
                     None if x0_c is None else place(x0_c, dtype, device), policy, **kw)
    if dis is not None:
        res = dataclasses.replace(res, x=res.x * torch.from_numpy(dis).to(res.x))
    return res


def _solve_other(method, A, b, x0, policy, dtype, device, kw):
    """``cgnr`` and ``lsmr`` (the host container: each places it and its
    transpose), and ``deflated_cg`` (a prebuilt ``deflation=``, or one built
    here at the solve's dtype from ``k=`` and ``m=``)."""
    b_dev = place(b, dtype, device)
    x0_dev = None if x0 is None else place(x0, dtype, device)
    if method == "cgnr":
        from conjugategradient_tpu_torch.solvers.cgnr import cgnr_solve

        return cgnr_solve(A, b_dev, x0_dev, policy, **kw)
    if method == "lsmr":
        from conjugategradient_tpu_torch.solvers.lsmr import lsmr_solve

        return lsmr_solve(A, b_dev, x0_dev, policy, **kw)
    from conjugategradient_tpu_torch.solvers.deflation import deflated_cg_solve, make_deflation

    deflation = kw.pop("deflation", None)
    if deflation is None:
        deflation = make_deflation(A, k=int(kw.pop("k", 8)), m=kw.pop("m", None),
                                   dtype=b_dev.dtype, device=device)
    return deflated_cg_solve(_place_matrix(A, dtype, device), b_dev, x0_dev, policy=policy,
                             deflation=deflation, **kw)


def _run(base, A, A_dev, b, x0, policy, M, kw):
    """The single-RHS solver of ``base`` on the placed matrix and vectors."""
    if base == "cg":
        from conjugategradient_tpu_torch.solvers.cg import cg_solve

        return cg_solve(A_dev, b, x0, policy, M=M, **kw)
    if base == "bicgstab":
        from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

        return bicgstab_solve(A_dev, b, x0, policy, M=M, **kw)
    if base == "idr":
        from conjugategradient_tpu_torch.solvers.idr import idr_solve

        return idr_solve(A_dev, b, x0, policy, M=M, **kw)
    if base == "minres":
        from conjugategradient_tpu_torch.solvers.minres import minres_solve

        return minres_solve(A_dev, b, x0, policy, M=M, **kw)
    if base == "gmres":
        from conjugategradient_tpu_torch.solvers.gmres import gmres_solve

        return gmres_solve(A_dev, b, x0, policy, M=M, **kw)
    if base == "fgmres":
        from conjugategradient_tpu_torch.solvers.gmres import (
            fgmres_solve,
            inner_solve_preconditioner,
        )

        inner = kw.pop("inner", None)
        if inner is not None:
            # inner-outer Krylov: the prefix's M preconditions the inner
            # solve; FGMRES sees the composed, nonlinear fixed-budget map
            M = inner_solve_preconditioner(A_dev, method=inner,
                                           iterations=int(kw.pop("inner_iterations", 8)), M=M)
        return fgmres_solve(A_dev, b, x0, policy, M=M, **kw)
    from conjugategradient_tpu_torch.solvers.cheby import chebyshev_solve, estimate_bounds

    if "bounds" not in kw:
        kw["bounds"] = estimate_bounds(A)
    return chebyshev_solve(A_dev, b, x0, policy, **kw)


def _solve_multi(A, B, X0, method, policy, grid, dtype, device, **kw):
    """Multi-RHS routing: ``cg``, ``jacobi_cg``, ``bjacobi_cg``,
    ``amg_cg``, ``mgcg``, ``refined`` and the BiCGStab family over (n, k)
    blocks."""
    if method == "refined":
        if not isinstance(A, DiaMatrix):
            raise TypeError("refined solve requires a DiaMatrix")
        from conjugategradient_tpu_torch.solvers.refine import refined_solve_multi

        return refined_solve_multi(A, B, X0, tol=policy.tol, norm=policy.norm, grid=grid,
                                   device=device, **kw)
    prefix, base = _split_prefix(method)
    if "mesh" in kw:
        return _solve_multi_mesh(A, B, X0, method, policy, grid, dtype, kw)
    if method not in _MULTI:
        if (prefix is not None and base == "chebyshev") or (
                base not in _KRYLOV + _OTHER + _HOST + ("chebyshev", "sharded_cg")
                and method != "cheb_cg"):
            _refuse(method)
        raise ValueError(f"method {method!r} does not support (n, k) right-hand sides")
    from conjugategradient_tpu_torch.solvers.multi import (
        as_multi_preconditioner,
        bicgstab_solve_multi,
        cg_solve_multi,
    )

    B_dev = place(B, dtype, device)
    X0_dev = None if X0 is None else place(X0, dtype, device)
    M = None
    if prefix is not None:
        M = _preconditioner(A, prefix, base, B_dev.dtype, device, grid, kw, multi=True)
    elif method == "mgcg":
        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy

        np_dtype = torch.empty(0, dtype=B_dev.dtype).numpy().dtype
        M = as_multi_preconditioner(build_hierarchy(A, grid, dtype=np_dtype, device=device))
    A_dev = _place_matrix(A, dtype, device)
    solver = bicgstab_solve_multi if base == "bicgstab" else cg_solve_multi
    return solver(A_dev, B_dev, X0_dev, policy, M=M, **kw)


def _solve_multi_mesh(A, B, X0, method, policy, grid, dtype, kw):
    """(n, k) blocks with ``mesh=``: the flat-band sharded block CG and
    BiCGStab (one halo pair and one (k,) psum per dot whatever k is) and
    the sharded multi-RHS MGCG, as the JAX facade routes them."""
    mesh = kw.pop("mesh")
    if method in ("sharded_cg", "cg", "bicgstab"):
        from conjugategradient_tpu_torch.parallel.shard_multi import sharded_cg_multi_solve

        return sharded_cg_multi_solve(A, B, X0, policy, mesh=mesh, dtype=dtype,
                                      method="bicgstab" if method == "bicgstab" else "cg", **kw)
    if method == "mgcg":
        from conjugategradient_tpu_torch.core.generators import LinearSystem
        from conjugategradient_tpu_torch.parallel.shard_multi import shard_multi_mgcg_solve

        if grid is None:
            raise ValueError("mgcg requires grid=")
        if not isinstance(A, DiaMatrix):
            raise TypeError("mgcg requires a DiaMatrix")
        system = LinearSystem(A, np.zeros(A.n), np.zeros(A.n))
        return shard_multi_mgcg_solve(system, B, grid, mesh=mesh, policy=policy, dtype=dtype,
                                      X0=X0, **kw)
    raise ValueError(
        f"method {method!r} with mesh= does not support (n, k) right-hand sides; use "
        "cg/bicgstab/mgcg or solve columns separately"
    )


def _solve_auto(A, b, x0, policy, grid, dtype, device, kw):
    """``method="auto"``: the route of ``_auto_method`` (``bicgstab`` for
    an (n, k) block where it picks ``idr``), and a host warning that
    diagnoses a stalled solve."""
    shape = getattr(A, "shape", None)
    if shape is not None and shape[0] != shape[1]:
        # rectangular: the only well-posed ask is least squares
        method = "lsmr"
    else:
        method = _auto_method(A, grid, device)
    if method == "idr" and np.ndim(b) == 2:
        # the (n, k) block carriers have no IDR form
        method = "bicgstab"
    res = solve(A, b, x0, method=method, tol=policy.tol, norm=policy.norm,
                min_iteration=policy.min_iteration, max_iteration=policy.max_iteration,
                grid=grid, dtype=dtype, device=device, **kw)
    conv = _host(res.converged)
    if not bool(conv.all()):
        resid, its = _host(res.residual), _host(res.iterations)
        warnings.warn(
            f"auto-dispatched method={method!r} stalled at residual "
            f"{float(resid.max()):.3e} (tol {policy.tol:.1e}, {int(its.max())} iterations"
            + (f", {int(conv.sum())}/{conv.size} columns converged" if conv.size > 1 else "")
            + "). Likely an fp32 attainable-accuracy floor. Try: a preconditioned route (grid= "
            "for mg_*, amg_* for no grid), method='refined' (fp64-tolerance mixed-precision "
            "refinement), or fp64.",
            RuntimeWarning,
            stacklevel=3,
        )
    return res


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def _auto_method(A, grid, device=None) -> str:
    """Pick a solver from the matrix's structure (a host probe; a device
    container is copied to the host first), as the JAX package picks.

    Nonsymmetric (beyond ``1e-12 * max|diag|``) -> IDR(s) (``mg_bicgstab``
    with a grid): fp32 BiCGStab stagnates on convection-dominated systems
    at scale where IDR(4) converges.  Symmetric and SPD-looking by
    ``_spd_probe`` (run on ``device``) -> CG (``mgcg`` with a grid);
    symmetric indefinite -> MINRES.  A deeply clustered interior negative
    eigenvalue can evade the probe: pass ``method="minres"`` when in doubt.
    """
    A = formats.to_host(A)
    diag = _diagonal(A)
    tol_sym = 1e-12 * float(np.max(np.abs(diag)))
    if not formats.is_symmetric(A, tol=tol_sym):
        return "mg_bicgstab" if grid is not None else "idr"
    if not _spd_probe(A, diag, device):
        return "minres"
    return "mgcg" if grid is not None else "cg"


def _spd_probe(A, diag=None, device=None) -> bool:
    """A positive diagonal and a 120-step full-reorthogonalisation host
    Lanczos lower bound above ``-1e-10 * |upper|`` (the JAX package's probe:
    30 steps miss a -1.5 lambda_1 Helmholtz shift on a 63x63 grid; 120
    resolve it), then, where that finds no negative eigenvalue, a longer
    plain Lanczos on ``device`` (``eigen.lanczos_ritz_bounds``, 4 sqrt(n)
    steps in fp64).

    The second stage is the port's repair of the JAX probe, whose 120 steps
    cannot resolve the bottom of a large spectrum: on 255^2 Helmholtz at
    1.5 lambda_1 (one eigenvalue at -0.5 lambda_1 = -1.5e-4 under a top of
    8) its lower bound is +7.1e-4 and ``auto`` picks CG; the plain
    recurrence crosses zero between 500 and 1000 steps.  Its Ritz values
    stay inside the spectrum's hull, so it only ever turns a wrong "SPD"
    into "indefinite": the choices agree wherever the JAX probe is right.
    """
    from conjugategradient_tpu_torch.solvers.eigen import lanczos_bounds, lanczos_ritz_bounds

    if diag is None:
        diag = _diagonal(A)
    n = A.shape[0]
    spd = bool(np.all(diag > 0))
    if spd:
        lo, hi = lanczos_bounds(lambda v: oracle.spmv(A, v), n, k=min(n, 120))
        spd = lo > -1e-10 * abs(hi)
    if spd and n > 120:
        A_dev = (A if isinstance(A, DiaMatrix) else formats._any_to_csr(A)).device_put(
            torch.float64, default_device(device))
        from conjugategradient_tpu_torch.ops.spmv import as_operator

        lo, hi = lanczos_ritz_bounds(as_operator(A_dev), n, 4 * int(np.ceil(np.sqrt(n))),
                                     device=device)
        spd = lo > -1e-10 * abs(hi)
    return spd


def eigs(
    A,
    k: int = 6,
    which: str = "LM",
    sigma: Optional[float] = None,
    method: str = "auto",
    mesh=None,
    tol: Optional[float] = None,
    grid=None,
    spd: Optional[bool] = None,
    device=None,
    **kw,
):
    """k eigenpairs of a sparse operator: the eigensolver facade.

    Returns ``solvers.arnoldi.EigsResult`` (complex numpy values and
    vectors, per-pair residuals, convergence flags) from every route, as
    the JAX package's ``eigs`` does.

    ``method``:
      - ``"auto"`` (default): symmetric positive definite operators with an
        extremal selection (LM, SM, LR, SR; no ``sigma``) go to the block
        solver LOBPCG (multiplicity-safe, preconditionable: ``grid=`` builds
        the MGCG hierarchy, or pass ``M=`` an (n, k) block map); everything
        else (nonsymmetric, indefinite, LI, shift-invert) to Krylov-Schur
        Arnoldi.  Symmetry is ``formats.is_symmetric(A, tol=1e-12 *
        max|diag|)``; definiteness is the port's ``_spd_probe``, whose card
        stage (the port's repair of the JAX probe) may send a large Helmholtz
        operator to Arnoldi where the JAX package wrongly takes LOBPCG.
      - ``"arnoldi"`` | ``"lobpcg"``: force a route.

    ``spd``: the caller's word for ``auto``: ``True`` routes to LOBPCG
    without the probe, ``False`` to Arnoldi.  Above 4,000,000 rows the probe
    never runs: a ``RuntimeWarning`` and Arnoldi.  ``sigma``: shift-invert
    (Arnoldi; nearest-to-sigma first; inner IDR(4) solves to ``inner_tol``,
    1e-10 in fp64 and 1e-3 in fp32: looser than the JAX package's 1e-6,
    which the port's inner solves do not reach in fp32; see
    ``solvers.arnoldi``).  ``tol``
    defaults to 1e-5 in fp32 and 1e-8 in fp64 on the LOBPCG route (whose
    default dtype is fp32) and to 1e-8 (relative to |lambda|) on Arnoldi's.
    ``device``: where the solve runs (``None``: the card when there is
    one).  The other keywords go to ``lobpcg`` or ``arnoldi_eigs``.
    ``mesh=`` (a 1-D ``parallel.mesh.Mesh``): the distributed twins,
    ``gspmd_lobpcg`` and ``gspmd_arnoldi_eigs``, row-sharded over it; with
    ``grid=`` on LOBPCG's smallest end ``M`` is the sharded V-cycle
    (``parallel.shard_mgcg.make_shard_vcycle``) on each shard's ``(k, n /
    num)`` rows, where the grid shards (the single-device block V-cycle on
    the mesh's first device where it does not).  ``device`` is then the
    mesh's first.
    """
    from conjugategradient_tpu_torch.solvers.arnoldi import EigsResult, arnoldi_eigs

    if method not in ("auto", "arnoldi", "lobpcg"):
        raise ValueError(f"unknown eigs method {method!r}; want auto|arnoldi|lobpcg")
    if which not in ("LM", "SM", "LR", "SR", "LI"):
        raise ValueError(f"unknown which={which!r}; want LM|SM|LR|SR|LI")
    device = default_device(device) if mesh is None else mesh.local_devices[0]
    if method == "auto":
        # LOBPCG selects by ALGEBRAIC extremes, so it needs SPD, not just
        # symmetry: on a symmetric indefinite operator LM/SM would return
        # the wrong end (the most negative Helmholtz mode for SM)
        eligible = sigma is None and which != "LI"
        is_matrix = hasattr(A, "shape") and not callable(A)
        if spd is not None:
            sym = eligible and bool(spd)
        elif eligible and is_matrix and A.shape[0] <= _PROBE_CAP:
            A_host = formats.to_host(A)
            sym = (formats.is_symmetric(A_host, tol=1e-12 * _diag_scale(A_host))
                   and _spd_probe(A_host, device=device))
        else:
            if eligible and is_matrix:
                warnings.warn(
                    f"eigs(method='auto'): n={A.shape[0]} exceeds the {_PROBE_CAP}-row "
                    "structure-probe cap; routing to Arnoldi.  Pass spd=True (or "
                    "method='lobpcg') for the symmetric block solver.",
                    RuntimeWarning,
                    stacklevel=2,
                )
            sym = False
        method = "lobpcg" if sym else "arnoldi"

    if method == "lobpcg":
        from conjugategradient_tpu_torch.solvers.lobpcg import lobpcg

        dt = formats.torch_dtype(kw.get("dtype", torch.float32))
        if tol is None:
            # fp32's attainable residual is ~2e-6 relative on the Poisson
            # LM end (the JAX package's measurement); 1e-5 keeps a margin
            tol = 1e-8 if dt == torch.float64 else 1e-5
        largest = which in ("LM", "LR")
        M = kw.pop("M", None)
        if M is None and grid is not None and not largest:
            # the smallest pairs of an SPD grid operator: the MGCG
            # hierarchy's V-cycle, one a column
            M = _eig_vcycle(A, tuple(grid), dt, device, mesh)
        if mesh is not None:
            from conjugategradient_tpu_torch.solvers.lobpcg import gspmd_lobpcg

            res = gspmd_lobpcg(A, k, mesh, axis=mesh.axis, M=M, largest=largest, tol=tol, **kw)
        else:
            res = lobpcg(A, k, M=M, largest=largest, tol=tol, device=device, **kw)
        vals = res.eigenvalues.to("cpu", torch.float64).numpy()
        # ascending from LOBPCG; most wanted first, as Arnoldi orders
        order = np.argsort(-vals if largest else vals, kind="stable")
        vecs = res.eigenvectors.to("cpu", torch.float64).numpy()[:, order]
        lam = vals[order]
        return EigsResult(
            values=lam.astype(np.complex128),
            vectors=vecs.astype(np.complex128),
            residuals=res.residuals.to("cpu", torch.float64).numpy()[order] * (np.abs(lam) + 1.0),
            matvecs=int(res.iterations) * 3 * k,
            restarts=int(res.iterations),
            converged=bool(res.converged),
        )

    if tol is None:
        tol = 1e-8  # relative to |lambda|, arnoldi_eigs' own default
    if mesh is not None:
        from conjugategradient_tpu_torch.solvers.arnoldi import gspmd_arnoldi_eigs

        return gspmd_arnoldi_eigs(A, k, mesh=mesh, axis=mesh.axis, which=which, sigma=sigma,
                                  tol=tol, **kw)
    return arnoldi_eigs(A, k, which=which, sigma=sigma, tol=tol, device=device, **kw)


def _eig_vcycle(A, grid, dt, device, mesh):
    """LOBPCG's multigrid ``M`` for ``eigs(grid=)``: the block V-cycle of the
    MGCG hierarchy on ``device`` (``(n, k)`` columns); over a mesh the
    sharded V-cycle on each shard's ``(k, n / num)`` rows where the grid
    shards, else the block V-cycle on the first device, the rows gathered
    there and split back (as GSPMD replicates a grid that does not
    divide)."""
    from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy
    from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner

    np_dtype = torch.empty(0, dtype=dt).numpy().dtype
    if mesh is not None:
        from conjugategradient_tpu_torch.parallel.mesh import shard_rows
        from conjugategradient_tpu_torch.parallel.shard_mgcg import make_shard_vcycle

        try:
            V = make_shard_vcycle(A, grid, mesh, mesh.axis, dtype=np_dtype)
        except ValueError:  # no level shards: the replicated cycle
            Mb = as_multi_preconditioner(build_hierarchy(A, grid, dtype=np_dtype, device=device))
            return lambda R: shard_rows(mesh, Mb(R.gather(1).T).T, dim=1)
        local = (grid[0] // mesh.size,) + grid[1:]
        return lambda R: V(R.reshape((R.shape[0],) + local)).reshape(R.shape[0], -1)
    return as_multi_preconditioner(build_hierarchy(A, grid, dtype=np_dtype, device=device))


def _diag_scale(A) -> float:
    try:
        return float(np.max(np.abs(_diagonal(A))))
    except Exception:
        return 1.0


def _to_csr(A) -> formats.CsrMatrix:
    return formats._any_to_csr(A)


def _diagonal(A):
    return formats.matrix_diagonal(A)
