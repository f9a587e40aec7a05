#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the kernels from ``conjugategradient_tpu_torch/csrc`` (one ``nvcc`` per
source, started together), checks each kernel against its plain PyTorch twin
on the card, then drives the port's paths through their public entry
points, each with the launch counts set to 0 just before it and read just
after:

- MGCG: ``poisson_system`` -> ``build_hierarchy`` (rediscretized
  const-stencil levels, Chebyshev pre=2/post=2) -> ``cg_solve`` with the
  V-cycle as preconditioner, on the 2-D 1023^2 and the 3-D 255^3 Poisson
  problems in fp32.  The counts show both stencil kernels ran (the fused
  Chebyshev kernel at every 3-D level).
- The flagship: ``WORKLOADS["cublas_flagship"]`` (n = 207,402, band 160) in
  fp64 -> ``refined_solve`` to an absolute ||r||_2 < 1e-8, three times: fp32
  legs, bf16 legs (``matrix_dtype``) and the fp64 device residual
  (``device_residual=True``); then ``api.solve(A, B, method="refined")`` with
  an n x 4 block.  The counts show the DIA SpMV ran in each of its three
  instantiations and as often as the iteration counts imply, and that the
  DIA SpMM ran.
- The variable-coefficient path: ``diffusion_system((255,)*3, kind="jump",
  contrast=1e3)`` -> ``build_hierarchy`` (Galerkin: 255^3 with 7 legs, then
  127^3 .. 15^3 with 27 legs each, dense 7^3) -> ``api.solve(method="mgcg")``
  in fp32; then ``diffusion_system((255,)*3, kind="smooth")`` ->
  ``refined_solve(grid=, matrix_dtype=torch.bfloat16)`` to an absolute
  ||r||_2 < 1e-8, host and device residual.  The counts show the
  variable-coefficient SpMV ran at every level, and on its bf16-leg
  instantiation as often as the iteration counts imply.
- The multi-RHS grid path: ``cg_solve_multi`` on the 255^3 jump system's DIA
  (the DIA SpMM at the CG level) with ``as_multi_preconditioner`` over its
  hierarchy, k = 4, column 0 the system's b (its iteration count must equal
  the single-RHS solve's); ``api.solve(B, method="mgcg")`` on 63^3 Poisson,
  card against CPU; ``refined_solve_multi(grid=, matrix_dtype=bf16)`` on the
  255^3 smooth system, k = 2 (column 0's counts must equal the single-RHS
  host route's).
- The default dtype: ``api.solve(method="mgcg")`` with dtype=None on the
  generators' fp64 Poisson systems at 127^3 and on the 1-D grid (262143,)
  (kernel #1's fp64 instantiations at every level, 3-D and 1-D patterns),
  each against the fp64 host oracle, and again from a b already on the card
  (the same x bit for bit); ``api.solve(A, B, method="cg")`` on the fp64
  flagship with n x 4 (kernel #5's fp64 instantiation).
- Kernel #6, the single-call accumulating DIA SpMM: the experiment module
  ``conjugategradient_tpu_torch.scripts.spmm_acc_experiment`` at its default
  shape (n = 414,720, band 160, k = 8), counted, and its measurement on the
  255^3 7-diagonal DIA at k = 4; then timed with bf16 legs at the default
  shape and at the flagship's band 160, k = 4, beside kernel #5.
- The rest of the multigrid build, fp32 MGCG through ``api.solve`` (each
  level's own kernel must launch): Poisson 256^3 with the default Galerkin
  hierarchy (a hybrid const fine level on kernels #1 and #2, then 81-leg
  levels at |shift| 2 on the wide kernel #3) and rediscretized (every level
  const), the latter also as a W-cycle MGCG and as fmg followed by MGCG;
  Poisson 1024^2 Galerkin with grid-stencil levels, with ``layout="dia"``
  (kernel #4 levels) and with the rbgs smoother; anisotropic 1024^2
  (semicoarsening); the reference's simple_cuda tridiagonal (n = 65,536,
  aggregation with smoothed transfers on kernel #1's 1-D view, then 1-D
  wide #3 levels) in fp32 and in fp64.  First the same kinds small in fp64
  on the card and on the CPU (equal iteration counts), and the wide kernel
  against its twin on NaN-carved x, each shape at the split of the legs its
  launch takes: the 256^3 hierarchy's 128^3 x 81, 64^3 x 125, 32^3 x 343 and
  16^3 x 1331, 512^2 x 21, 1-D 32768 x 5 and a 64^3 hierarchy's 16^3 x 125;
  kernels #1 and #2 on the even grids 256^3 and (256, 255, 254) with the
  other checks.  The 256^3 Galerkin MGCG's profile splits the wide
  kernel's device time by level (each launch's grid and block dims in the
  trace).
- The formats slice.  Kernels #4 and #5 (k = 4) past 256 diagonals, fp32
  and fp64, against their twins on the 16^3 levels of the 128^3 (343
  diagonals) and 256^3 (1331) hierarchies as DIA, in chained launches; then
  ``api.solve(method="mgcg", layout="dia")`` on Poisson 128^3 fp32, #4 at
  every level (the 343-diagonal one in whole chains), beside the
  stencil-layout solve.  The reference's own storage in fp64 with each
  workload's policy: the flagship as CSR through ``api.solve`` (cuSPARSE's
  product, no #4 launch; run twice, bit-identity printed) and through
  ``make_kernel_operator`` (#4 once per iteration and once more), then an
  n x 4 block; ``WORKLOADS["handmade_cl"]`` as diagonal-first ELL both
  ways.  Matrix Market: Poisson 127^3 fp32 permuted by a seeded symmetric
  permutation must load as CSR and solve with no #4 launch; unpermuted it
  must load as DIA, solve on #4 and, as an n x 4 block, on #5.  Every
  format's SpMV and SpMM (k = 4) against the fp64 oracle, timed beside its
  bound, and #4/#5 past 256 diagonals timed beside cuSPARSE.

Kernels #1 (every pattern and the run-time one, 1-D to 3-D, fp32 and fp64,
NaN-carved x), #5 (fp32, bf16 and fp64 legs) and #6 (fp32 and bf16 legs,
NaN-planted X at k = 3 and 8) are held to their twins first, and the ptxas
report of every instantiation of #1, #2, #3, #5 and #6 must show a 0-byte
stack frame and no spills; #6's blocks per SM and waves at its main shapes
are printed.

Every phase has a bound and any miss, build failure or launch failure ends
the run with a non-zero exit before the last line.  The last line is
``{"ok": true, "device": {...}}``; the line before it holds the per-kernel
record: launches on the fp32 paths above (``launches``) and each path's own
count, the default-dtype ones too (``launches_by_path``), worst error
against the twin, kernel and twin times, the least time the card could
take (``bound_ms``: the bytes each input read once and each output written
once at 3.35 TB/s, or the fp32 operations at 67 TFLOP/s, whichever is
longer; ``bound_by`` says which) and the time of one PyTorch call that
computes the same function (``library_ms``: a convolution for the const
stencil, cuSPARSE's CSR
product for the variable stencil and the DIA kernels; none for the
Chebyshev smoother).  The library calls are yardsticks here and nowhere in
the port.  Times come from CUDA events after a warm-up and each is printed
beside the card's name and power limit.
"""

from __future__ import annotations

import collections
import copy
import itertools
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators, oracle
from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    CsrMatrix,
    DiaMatrix,
    StencilMatrix,
    csr_to_bsr,
    csr_to_coo,
    csr_to_ell,
    dia_to_csr,
    dia_to_dense,
    dia_to_stencil,
    stencil_to_const,
    stencil_to_dia,
    to_host,
)
from conjugategradient_tpu_torch.core.io import (
    from_scipy,
    load_matrix_market,
    save_matrix_market,
    to_scipy,
)
from conjugategradient_tpu_torch.models.workloads import WORKLOADS
from conjugategradient_tpu_torch.ops import _build, cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.ops.card import (
    SMS,
    blocks_per_sm,
    bound_ms,
    card_name,
    dia_nnz,
    graph_ms,
    spmm_bytes,
    time_ms,
)
from conjugategradient_tpu_torch.ops.cuda_dia import (
    TAGS,
    dia_groups,
    k_chunks,
    make_kernel_operator,
    spmm_dia_acc_cuda,
    spmm_dia_acc_ref,
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
)
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    cheb_geometry,
    cheb_smooth_const_cuda,
    cheb_smooth_const_ref,
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
    spmv_stencil_cuda,
    spmv_stencil_ref,
    spmv_stencil_wide_cuda,
    var_route,
    wide_geometry,
    wide_view,
)
from conjugategradient_tpu_torch.ops.spmm import spmm
from conjugategradient_tpu_torch.ops.spmv import as_operator, prepare
from conjugategradient_tpu_torch.precond.multigrid import (
    _const_bounds,
    _fused_cheb_ok,
    as_preconditioner,
    build_hierarchy,
    fmg,
)
from conjugategradient_tpu_torch.scripts import spmm_acc_experiment
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner, cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi

#: max |kernel - twin| <= KERNEL_REL * max |twin|: same leg order in fp32
#: (or bf16 legs with fp32 accumulation), only FMA contraction differs.
KERNEL_REL = 1e-5
#: the same bound for the fp64 DIA instantiation.
KERNEL_REL64 = 1e-13
#: solver tolerance (rel_l2) and the bound on the true fp64 relative
#: residual of the fp32 solution (the fp32 drift floor).
TOL = 1e-6
TRUE_REL = 1e-5
#: card vs CPU solution of the same small solve: fp32 rounding differs
#: (FMA contraction, reduction order), the iterations are the same.
SMALL_AGREE = 1e-4

SEED = 0
GRID_2D = (1023, 1023)
GRID_3D = (255, 255, 255)
SPMV_GRIDS = [(1023, 1023), (37, 53), (255, 255, 255), (23, 9, 12), (4095,), (300,)]
#: kernel #1's hand-made stencils (random coefficients): every compile-time
#: pattern on grids with interior blocks and ragged edges (nz = 1 for the
#: 3-D ones), the legs reversed and a short list (the run-time pattern);
#: each in fp32 and fp64, and in fp64 on a NaN-carved x
_T27 = tuple(itertools.product((-1, 0, 1), repeat=3))
_STAR7 = tuple(s for s in _T27 if sum(map(abs, s)) <= 1)
CONST_HAND = [
    ("3-point (4095,)", ((-1,), (0,), (1,)), (4095,)),
    ("5-point (40, 600)", ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), (40, 600)),
    ("9-point (41, 299)", tuple(s[1:] for s in _T27 if s[0] == 0), (41, 299)),
    ("7-point (13, 20, 70)", _STAR7, (13, 20, 70)),
    ("7-point nz=1 (1, 17, 65)", _STAR7, (1, 17, 65)),
    ("27-point (13, 20, 70)", _T27, (13, 20, 70)),
    ("27-point nz=1 (1, 17, 65)", _T27, (1, 17, 65)),
    ("7-point reversed (13, 20, 70)", _STAR7[::-1], (13, 20, 70)),
    ("2 legs (1000,)", ((0,), (1,)), (1000,)),
    ("13 legs (13, 20, 70)", _T27[:13], (13, 20, 70)),
]
#: kernel #1's timed shapes beyond the record's 255^3 fp32: (label, shifts,
#: grid), timed as a CUDA graph's replay (``graph_ms``): at a few µs a
#: kernel outruns the host's launches
TIME_CONST = [("255^3 7-point", _STAR7, (255, 255, 255)),
              ("127^3 27-point", _T27, (127, 127, 127)),
              ("1023^2 5-point", ((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), (1023, 1023)),
              ("(1048575,) 3-point", ((-1,), (0,), (1,)), (1048575,))]
#: the default-dtype (fp64) MGCG: Poisson at 127^3 (a 255^3 Galerkin setup
#: costs ~20 s of host time) and on a 1-D grid, to rel_l2 1e-10; the true
#: fp64 relative residual by the host oracle must be within FP64_TRUE_REL
FP64_GRIDS = [(127, 127, 127), (262143,)]
FP64_TOL = 1e-10
FP64_TRUE_REL = 1e-9
CHEB_GRIDS = [(24, 9, 12), (63, 63, 63), (255, 255, 255)]
#: kernel #2's edge grids: nz below the pipeline's stages, nz not a multiple
#: of the z chunk, nx and ny not multiples of the (32, 16) tile; checked at
#: degrees 1, 2 and 5, and the last with its legs in reverse order (the
#: instantiation that reads its shifts at run time)
CHEB_EDGE_GRIDS = [(3, 40, 70), (37, 20, 40), (37, 21, 45)]
CHEB_EDGE_DEGREES = (1, 2, 5)
SMALL_GRIDS = [(63, 63), (31, 31, 31)]
TIME_SPMV_GRIDS = [(1023, 1023), (255, 255, 255), (63, 63, 63)]
TIME_CHEB_GRIDS = [(255, 255, 255), (127, 127, 127), (63, 63, 63)]
#: kernel #2's timed variants: (label, zero x0, residual) at degree 2
CHEB_VARIANTS = (("pre: zero x0 + resid", True, True), ("post: given x0", False, False),
                 ("h=3: given x0 + resid", False, True))

#: the flagship: fp64 contract, fp32 inner solves (bench.py's call)
FLAGSHIP = "cublas_flagship"
FLAGSHIP_TOL = 1e-8
FLAGSHIP_INNER_TOL = 1e-4
#: multi-RHS columns vs their single-RHS refined solves, and the card vs the
#: CPU on the small refined solve: both fp64-converged to ||r|| < 1e-8, so
#: the solutions agree far below fp32 rounding.
MULTI_AGREE = 1e-7
SMALL_REFINE = (4096, 32)
SPMM_KS = (1, 3, 4, 8)
#: leg dtypes of the kernels with an instantiation per leg dtype (#3, #4)
LEG_DTYPES = tuple(TAGS)

#: the variable-coefficient path: 255^3 diffusion, jump field (contrast 1e3)
#: for fp32 MGCG, smooth field for the bf16-leg refined solve
VAR_GRID = (255, 255, 255)
#: the smooth field's grid for the bf16-leg refined solves (one RHS and
#: k = 2): cut from 255^3 to 127^3 when the rest of the multigrid build
#: joined the run, which keeps the whole run near half its time limit (the
#: 255^3 smooth hierarchy's setup, host residual route and k = 2 block took
#: ~220 s of host time on the H100 machine's CPU)
SMOOTH_GRID = (127, 127, 127)
VAR_CONTRAST = 1e3
VAR_SMALL = (31, 31, 31)
#: kernel #3's small check shapes: (label, grid) of diffusion operators
VAR_CHECK_GRIDS = [("2-D (25, 19) 5 legs, ragged", (25, 19)), ("2-D 1023^2 5 legs", (1023, 1023)),
                   ("3-D (17, 13, 11) 7 legs", (17, 13, 11))]
SHIFTS27 = tuple(itertools.product((-1, 0, 1), repeat=3))
#: kernel #3's hand-made edge stencils (random legs): leg counts without an
#: instantiation of their own (13, 19), a grid of boundary blocks only,
#: nz = 1, and a ragged 2-D grid with interior blocks
VAR_HAND = [("13 legs (10, 18, 66)", SHIFTS27[:13], (10, 18, 66)),
            ("19 legs (10, 18, 66)", tuple(s for s in SHIFTS27 if sum(map(abs, s)) <= 2), (10, 18, 66)),
            ("7 legs (3, 3, 3)", tuple(s for s in SHIFTS27 if sum(map(abs, s)) <= 1), (3, 3, 3)),
            ("7 legs nz=1 (1, 17, 65)", tuple(s for s in SHIFTS27 if sum(map(abs, s)) <= 1), (1, 17, 65)),
            ("9 legs 2-D (40, 600)", tuple(s[1:] for s in SHIFTS27 if s[0] == 0), (40, 600))]
#: solve walls of this script's two runs on the tree before the redesign of
#: kernels #1 and #5 (NVIDIA H100 80GB HBM3, 700.00 W), printed beside this
#: run's
WALLS_BEFORE_MS = {
    "MGCG 2-D 1023^2 solve": "42.8 / 31.1",
    "MGCG 3-D 255^3 solve": "53.8 / 42.7",
    "MGCG jump 255^3 warm solve": "361.1 / 432.6",
    "multi-RHS MGCG jump 255^3 k=4": "810.2 / 1606.9",
}

#: the rest of the multigrid build, at full size: Poisson 256^3 (hybrid
#: fine level, Galerkin levels of 81 legs at |shift| 2; and rediscretized,
#: every level const), Poisson 1024^2 (2-D hybrid: stencil levels, DIA
#: levels, the rbgs smoother), anisotropic 1024^2 (semicoarsening) and the
#: reference's simple_cuda tridiagonal n = 65,536 (aggregation)
KIND_GRID_3D = (256, 256, 256)
KIND_GRID_2D = (1024, 1024)
KIND_RATIOS = (1e-3, 1.0)
KIND_TRIDIAG = 65536
#: the same kinds small, on the card and on the CPU in fp64: (label, system
#: kind, grid, build keywords, cycle index)
KIND_SMALL = [("Galerkin Poisson 64^3", "poisson", (64, 64, 64), {}, 1),
              ("rediscretized Poisson 64^3 W-cycle", "poisson", (64, 64, 64), "redisc", 2),
              ("Galerkin Poisson 64^2 layout dia", "poisson", (64, 64), dict(layout="dia"), 1),
              ("Galerkin Poisson 64^2 rbgs", "poisson", (64, 64), dict(smoother="rbgs"), 1),
              ("anisotropic 128^2", "aniso", (128, 128), {}, 1),
              ("tridiagonal 4096", "tridiagonal", (4096,), {}, 1)]
#: kernels #1 and #2 on even grids (every block full) before any solve
EVEN_GRIDS = [(256, 256, 256), (256, 255, 254)]

#: kernel #6 (single-call accumulating SpMM) against kernel #5: two rounding
#: orders of the same fp32 sum (groups into partials, or one running sum)
ACC_VS_SPMM = 1e-6
#: kernel #6 against the fp64 oracle (the JAX experiment's bound)
ACC_VS_ORACLE = 1e-5
#: (label, n, band) of kernel #6's checks; the flagship's n at band 160
ACC_CASES = [("band 32 n=65536", 65536, 32), ("band 160 n=207402", 207402, 160)]
#: the column counts of its NaN-planted checks (8: the widest window)
ACC_NAN_KS = (3, 8)
#: the multi-RHS grid path: columns of the 255^3 jump MGCG, of the 63^3
#: facade run, of the 255^3 smooth refined solve
MULTI_K = 4
FACADE_GRID = (63, 63, 63)
REFINE_MULTI_K = 2
#: kernel #6's two measured shapes: the experiment's default, the 255^3
#: jump operator as a 7-diagonal DIA (the multi-RHS MGCG's CG level)
ACC_MAIN = "n=414720 band=160 k=8"
ACC_DIA7 = f"255^3 7 diagonals k={MULTI_K}"
#: and two more: the main shape with bf16 legs, the flagship at k = 4
ACC_MAIN_BF16 = "n=414720 band=160 k=8 bf16 legs"
ACC_FLAGSHIP = "n=207402 band=160 k=4"

#: the formats slice: kernels #4 and #5 past 256 diagonals on the 16^3
#: levels of the 128^3 and 256^3 DIA-layout hierarchies (#5 at MANY_K
#: columns), and the MGCG over the first; the HandmadeCL workload as ELL;
#: Matrix Market ingestion of Poisson MTX_GRID; every format's product, BSR
#: in BSR_BLOCK blocks of Poisson DIA_MGCG_GRID, dense at DENSE_N rows
DIA_MGCG_GRID = (128, 128, 128)
DIA_MGCG_MANY = 343
MANY_K = 4
HANDMADE = "handmade_cl"
MTX_GRID = (127, 127, 127)
BSR_BLOCK = (8, 8)
DENSE_N = 8192
FORMAT_K = 4
#: fp64 products of the plain formats against the fp64 oracle: the same
#: products summed in another order
FORMAT_REL64 = 1e-12
#: plain fp64 CG on the flagship: the true ||b - A x||_2 it can reach.  Its
#: recursive residual passes the policy's 1e-8 long before the 200 minimum
#: iterations (the fp64 oracle, core.oracle.cg, ends at 6.7e-91), but the
#: true residual stalls at fp64's attainable accuracy for this system: the
#: oracle's own x leaves 6.0e-8 (3.1e-11 of ||b|| = 3220), the card's
#: routes 1.76e-8 (cuSPARSE) and 5.99e-8 (kernel #4), so this bound is
#: 1.67x over the worse reading; refined_solve is the route that reaches a
#: true 1e-8
FLAGSHIP_CG_TRUE = 1e-7
#: ... and each route within this factor of the same reading by scipy's
#: textbook CG, the witness that is not the port's: the spread of that
#: reading when only the products' summation order differs (3.2x between
#: the port's CSR route and the JAX package's CG at 4096 rows in
#: tests/test_torch_sparse_ops.py, 3.4x between the card's two routes)
CG_ORDER_SPREAD = 4.0

KERNELS = {
    "spmv_const_stencil": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:127",
    ),
    "cheb_smooth_const": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:288",
    ),
    "spmv_dia": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:193",
    ),
    "spmm_dia": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:421",
    ),
    "spmv_stencil": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil_var.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:177",
    ),
    "spmm_dia_acc": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="scripts/spmm_acc_experiment.py:64",
    ),
    "spmv_stencil_wide": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/stencil_var.cu",
        replaces="conjugategradient_tpu/ops/pallas_stencil.py:177",
    ),
}


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _const_poisson(A_dia, grid):
    A = stencil_to_const(dia_to_stencil(A_dia, grid, copy=False))
    _require(A is not None, f"Poisson operator on {grid} is not a const stencil")
    return A


def _max_err(out, ref):
    outs = out if isinstance(out, tuple) else (out,)
    refs = ref if isinstance(ref, tuple) else (ref,)
    err = max(float((o - r).abs().max()) for o, r in zip(outs, refs))
    scale = max(float(r.abs().max()) for r in refs)
    return err, scale


def _cheb_flops(nlegs: int, degree: int, zero_x: bool, want_resid: bool) -> int:
    """fp32 operations per point of one fused smoothing
    (``cheb_smooth_const_ref``): the initial residual (2 from a zero x0: a
    scaling and the division by theta; with a given x0 also the SpMV and the
    subtraction), ``degree`` x updates, an r update (SpMV, scaling,
    subtraction) per application of A to d, and ``degree - 1`` d updates
    of 3.  The degree-2 pre-smooth with 7 legs: 39."""
    init = 2 if zero_x else 2 * nlegs + 3
    return init + degree + (degree - 1 + int(want_resid)) * (2 * nlegs + 2) + 3 * (degree - 1)


def _cheb_bytes(n: int, zero_x: bool, want_resid: bool) -> int:
    """Bytes one fused smoothing must move: b [and x0] read once, x [and r]
    written once, fp32."""
    return 4 * n * (2 + (0 if zero_x else 1) + int(want_resid))


def _cheb_checks(label, A, lo, hi, invd, rand, errs, degrees=(1, 2)):
    """Kernel #2 against its twin on ``A``: each of ``degrees``, from a zero
    or a given x0, with and without the residual."""
    b, x0 = rand(A.grid), rand(A.grid)
    for degree in degrees:
        for xin in (None, x0):
            for want_resid in (False, True):
                args = (A, b, xin, degree, hi, lo, invd, want_resid)
                err, scale = _max_err(cheb_smooth_const_cuda(*args), cheb_smooth_const_ref(*args))
                torch.cuda.synchronize()
                tag = (f"cheb {label} degree={degree} x0={'zero' if xin is None else 'given'} "
                       f"resid={want_resid}")
                _require(err <= KERNEL_REL * scale, f"{tag}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
                errs["cheb_smooth_const"] = max(errs["cheb_smooth_const"], err)
                print(f"cheb_smooth_const {tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")


def _cheb_galerkin_checks(dev, rand, errs):
    """Kernel #2 on the coarse levels of the facade's 63^3 Poisson Galerkin
    hierarchy (the one ``api.solve(B, method="mgcg")`` builds): 27-leg
    const-detected stencils, with the level's own bounds and 1/diag."""
    s = generators.poisson_system(FACADE_GRID, dtype=np.float32)
    h = build_hierarchy(s.A, FACADE_GRID, dtype=np.float32, device=dev)
    for lvl in h.levels[1:]:
        _require(isinstance(lvl.A, ConstStencilMatrix) and lvl.A.nlegs == 27
                 and _fused_cheb_ok(lvl, torch.empty(lvl.grid, device=dev)),
                 f"facade {FACADE_GRID} level {lvl.grid}: not a 27-leg fused-smoother level")
        lo, hi = lvl.cheb_bounds
        _cheb_checks(f"{lvl.grid} 27-leg Galerkin level of {FACADE_GRID}", lvl.A, lo, hi,
                     lvl.inv_diag, rand, errs)


def _const_kernel_checks(dev, errs):
    """Kernel #1 against its twin: Poisson operators of SPMV_GRIDS (1-D, 2-D,
    3-D) and the hand-made CONST_HAND stencils, each in fp32 and fp64, and
    every hand-made one in fp64 on an x carved out of a NaN-filled buffer (a
    read outside the grid would leak a NaN)."""
    rng = np.random.default_rng(SEED + 5)
    cases = [(f"Poisson {g}", _const_poisson(generators.poisson_system(g).A, g))
             for g in SPMV_GRIDS + EVEN_GRIDS]
    for label, shifts, g in CONST_HAND:
        coeffs = tuple(float(c) for c in rng.uniform(-1, 1, len(shifts)))
        cases.append((label, ConstStencilMatrix(coeffs, shifts, g)))
    for label, A in cases:
        spec = cuda_stencil.const_view(A.grid, A.shifts).spec
        x64 = torch.from_numpy(rng.standard_normal(A.grid)).to(dev)
        inputs = [(torch.float32, x64.float()), (torch.float64, x64)]
        if not label.startswith("Poisson"):
            buf = torch.full((x64.numel() + 8192,), float("nan"), dtype=torch.float64, device=dev)
            carved = buf[4096 : 4096 + x64.numel()].view(A.grid)
            carved.copy_(x64)
            inputs.append(("fp64 NaN-carved", carved))
        for tag, x in inputs:
            rel = KERNEL_REL64 if x.dtype == torch.float64 else KERNEL_REL
            y, ref = spmv_const_stencil_cuda(A, x), spmv_const_stencil_ref(A, x)
            torch.cuda.synchronize()
            _require(y.dtype == x.dtype and not bool(torch.isnan(y).any()),
                     f"spmv_const_stencil {label} {tag}: dtype {y.dtype} or a NaN")
            err, scale = _max_err(y, ref)
            _require(err <= rel * scale, f"spmv_const_stencil {label} {tag}: max err {err:.3e} > "
                                         f"{rel}*{scale:.3e}")
            if x.dtype == torch.float32:
                errs["spmv_const_stencil"] = max(errs["spmv_const_stencil"], err)
        print(f"spmv_const_stencil {label} (pattern {spec or 'run-time'}): fp32 and fp64 within "
              f"{KERNEL_REL} / {KERNEL_REL64} of max|twin|" +
              ("" if label.startswith("Poisson") else "; NaN-carved fp64 x: no NaN"))


def _fp64_mgcg(dev, card):
    """The default-dtype MGCG: ``api.solve(method="mgcg")`` with dtype=None on
    the generators' fp64 Poisson systems of FP64_GRIDS over a hierarchy built
    once (fp64 levels: kernel #1 in fp64 at every level, no kernel #2),
    counted, then the same solve from a b already on the card (the same x
    bit for bit).  Returns {path: kernel #1's launches in its counted
    solve}."""
    out = {}
    for g in FP64_GRIDS:
        s = generators.poisson_system(g)
        t0 = time.perf_counter()
        h = build_hierarchy(s.A, g, device=dev)
        setup_s = time.perf_counter() - t0
        kw = dict(method="mgcg", grid=g, tol=FP64_TOL, norm="rel_l2", hierarchy=h, device=dev)
        _reset_counts()
        t0 = time.perf_counter()
        res = api.solve(s.A, s.b, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        by_grid = dict(spmv_const_stencil_cuda.launches_by_grid)
        by_dtype = dict(spmv_const_stencil_cuda.launches_by_dtype)
        tag = f"default-dtype MGCG Poisson {g}"
        out[tag] = spmv_const_stencil_cuda.launches
        _require(res.converged and res.x.dtype == torch.float64,
                 f"{tag}: converged {res.converged}, x {res.x.dtype}")
        rel = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
        _require(rel <= FP64_TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {FP64_TRUE_REL}")
        _require(set(by_dtype) == {"fp64"} and cheb_smooth_const_cuda.launches == 0,
                 f"{tag}: kernel #1 by dtype {by_dtype}, kernel #2 {cheb_smooth_const_cuda.launches}")
        for lvl in h.levels:
            _require(by_grid.get(lvl.grid, 0) > 0, f"{tag}: no kernel #1 launch at level {lvl.grid}")
        res_dev = api.solve(s.A, torch.from_numpy(s.b).to(dev), **kw)
        _require(res_dev.iterations == res.iterations and torch.equal(res_dev.x, res.x),
                 f"{tag}: b on the card gives another x ({res_dev.iterations} iterations)")
        print(f"{tag}: {res.iterations} iterations, true fp64 rel residual {rel:.3e}, levels "
              f"{[l.grid for l in h.levels]} (patterns "
              f"{[cuda_stencil.const_view(l.grid, l.A.shifts).spec for l in h.levels]}), kernel #1 "
              f"launches {by_dtype} by grid { {str(k): v for k, v in by_grid.items()} }; b on the "
              "card: the same x bit for bit")
        print(f"time {tag}: solve {wall_ms:.3f} ms, host hierarchy setup {setup_s:.3f} s [{card}]")
    return out


def _fp64_block_cg(fsys, dev, card):
    """``api.solve(A, B, method="cg")`` on the flagship in fp64 (dtype=None)
    with B = [b, three seeded normal columns], counted: kernel #5's fp64
    instantiation once per iteration plus the initial residual; every column
    converges to rel_l2 FP64_TOL with its true fp64 residual within
    FP64_TRUE_REL.  Returns kernel #5's launches."""
    rng = np.random.default_rng(SEED + 6)
    B = np.column_stack([fsys.b] + [rng.standard_normal(fsys.n) for _ in range(MULTI_K - 1)])
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(fsys.A, B, method="cg", tol=FP64_TOL, norm="rel_l2", device=dev)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    by_dtype = dict(spmm_dia_cuda.launches_by_dtype)
    its = res.iterations.tolist()
    tag = f"fp64 flagship block CG n x {MULTI_K}"
    _require(bool(res.converged.all()) and res.x.dtype == torch.float64,
             f"{tag}: converged {res.converged.tolist()}, its {its}, x {res.x.dtype}")
    X = res.x.cpu().numpy()
    rels = [_host_rel_residual(fsys.A, B[:, j], X[:, j]) for j in range(MULTI_K)]
    _require(max(rels) <= FP64_TRUE_REL, f"{tag}: true fp64 relative residuals {rels}")
    _require(by_dtype == {"fp64": max(its) + 1},
             f"{tag}: spmm_dia launches {by_dtype} != fp64 iterations + 1 ({max(its) + 1})")
    print(f"{tag}: iterations per column {its}, true fp64 rel residuals "
          f"{[float(f'{r:.3e}') for r in rels]}, spmm_dia launches {by_dtype}")
    print(f"time {tag}: wall {wall_ms:.3f} ms [{card}]")
    return spmm_dia_cuda.launches


def _conv(A, x):
    """One PyTorch call that computes A x for a const stencil on grid-shaped
    ``x``: ``conv1d``/``conv2d``/``conv3d`` with the coefficients as a 3^d
    cross-correlation kernel and zero padding (the Dirichlet boundary)."""
    d = len(A.grid)
    w = torch.zeros((1, 1) + (3,) * d, dtype=x.dtype, device=x.device)
    for c, s in zip(A.coeffs, A.shifts):
        w[(0, 0) + tuple(1 + v for v in s)] = c
    conv = (F.conv1d, F.conv2d, F.conv3d)[d - 1]
    return lambda: conv(x[None, None], w, padding=1)[0, 0]


def _const_times(dev, card):
    """Kernel #1 at TIME_CONST's shapes in fp32 and fp64 (random
    coefficients; the 255^3 fp32 row repeats the record's shape), each with
    its twin, its library call (``_conv``, eager) and its bound: x read
    once, y written once.  The 1023^2 and 1-D grids lie in the 50 MB L2,
    which a graph's replay keeps warm: there the HBM bound is not one."""
    rng = np.random.default_rng(SEED + 7)
    for label, shifts, g in TIME_CONST:
        A = ConstStencilMatrix(tuple(float(c) for c in rng.uniform(-1, 1, len(shifts))), shifts, g)
        n = int(np.prod(g))
        for dtype in (torch.float32, torch.float64):
            x = torch.randn(g, device=dev, dtype=dtype)
            ms = graph_ms(lambda: spmv_const_stencil_cuda(A, x), 200 if n < 2e6 else 50)
            p_ms = time_ms(lambda: spmv_const_stencil_ref(A, x), 10)
            tag = f"spmv_const_stencil {label} {TAGS[dtype]}"
            lib_ms = _library(tag, _conv(A, x), spmv_const_stencil_cuda(A, x), card,
                              100 if n < 2e6 else 20)
            nbytes = 2 * n * x.element_size()
            bound = bound_ms(nbytes, 2 * A.nlegs * n)
            print(f"time {tag} (graph): kernel {ms:.4f} ms ({nbytes / 1e6 / ms:.0f} GB/s of "
                  f"{nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.1%} "
                  f"of it), twin {p_ms:.4f} ms, library call {lib_ms:.4f} ms [{card}]")


def _true_rel_residual(A, b, x) -> float:
    """||b - A x|| / ||b|| in fp64 on the card, through the plain twin."""
    b64, x64 = b.double(), x.double().reshape(b.shape)
    r = b64 - spmv_const_stencil_ref(A, x64)
    return float(torch.linalg.vector_norm(r) / torch.linalg.vector_norm(b64))


def _mgcg(system, grid, device):
    """The main path: hierarchy setup, then MGCG through the public entry points."""
    t0 = time.perf_counter()
    h = build_hierarchy(
        system.A, grid, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
        coarse_operator=generators.poisson_coarse_operator(np.float32), device=device,
    )
    setup_s = time.perf_counter() - t0
    b = torch.from_numpy(system.b).to(device).reshape(grid)
    policy = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=8 * system.n)
    M = as_preconditioner(h)
    solve = lambda: cg_solve(h.levels[0].A, b, policy=policy, M=M, precise_dot=True)
    return h, b, solve, setup_s


def _check_solution(tag, A, b, res):
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    _require(tuple(res.x.shape) == tuple(b.shape), f"{tag}: x has shape {tuple(res.x.shape)}")
    _require(bool(torch.isfinite(res.x).all()), f"{tag}: x is not finite")
    rel = _true_rel_residual(A, b, res.x)
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    return rel


def _dia_cases(flagship_A):
    """(label, host DiaMatrix) of the DIA kernel checks: the flagship, a
    ragged band, the tridiagonal workload, and 2-D/3-D Poisson operators as
    flat DIA (far offsets +-1023 and +-3969)."""
    return [
        (f"banded_sin n={flagship_A.n} band=160", flagship_A),
        ("banded_sin n=333 band=8", generators.banded_sin_matrix(333, 8)),
        ("tridiagonal n=65536", generators.tridiagonal_matrix(65536)),
        ("poisson2d 1023^2", generators.poisson2d_matrix(1023)),
        ("poisson3d 63^3", generators.poisson3d_matrix(63)),
    ]


def _dia_kernel_checks(cases, dev, errs):
    """Kernel #4 and kernel #5 (k in SPMM_KS; fp32, bf16 and fp64 legs;
    #4 plain and fused) against their twins; every SpMM column must equal
    the single-RHS kernel bit for bit (same legs, same order, explicit
    fma)."""
    rng = np.random.default_rng(SEED)
    for label, A_host in cases:
        for legs in LEG_DTYPES:
            A = A_host.device_put(legs, dev)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            tag = f"{label} {TAGS[legs]} legs"
            x = torch.from_numpy(rng.standard_normal(A.n)).to(dev, vec)
            y, ref = spmv_dia_cuda(A, x), spmv_dia_ref(A, x)
            yf, dot = spmv_dot_dia_cuda(A, x)
            ref_dot = torch.dot(x, ref)
            torch.cuda.synchronize()
            err, scale = _max_err(y, ref)
            _require(err <= rel * scale, f"spmv_dia {tag}: max err {err:.3e} > {rel}*{scale:.3e}")
            _require(torch.equal(yf, y), f"spmv_dot_dia {tag}: fused A p differs from the SpMV's")
            dot_err = abs(float(dot) - float(ref_dot))
            dot_scale = float((x.abs() * ref.abs()).sum())
            _require(dot_err <= rel * dot_scale,
                     f"spmv_dot_dia {tag}: p.Ap err {dot_err:.3e} > {rel}*{dot_scale:.3e}")
            errs["spmv_dia"] = max(errs["spmv_dia"], err)
            print(f"spmv_dia {tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}); "
                  f"fused p.Ap err {dot_err:.3e} (sum|p Ap| {dot_scale:.3e})")
            worst = 0.0
            for k in SPMM_KS:
                X = torch.from_numpy(rng.standard_normal((k, A.n))).to(dev, vec)
                Y, ref = spmm_dia_cuda(A, X), spmm_dia_ref(A, X)
                torch.cuda.synchronize()
                err, scale = _max_err(Y, ref)
                _require(err <= rel * scale,
                         f"spmm_dia {tag} k={k}: max err {err:.3e} > {rel}*{scale:.3e}")
                same = all(torch.equal(Y[j], spmv_dia_cuda(A, X[j])) for j in range(k))
                _require(same, f"spmm_dia {tag} k={k}: a column differs from the single-RHS kernel")
                worst = max(worst, err)
            if legs != torch.float64:
                errs["spmm_dia"] = max(errs["spmm_dia"], worst)
            print(f"spmm_dia {tag} k={SPMM_KS}: max|kernel-twin| {worst:.3e}; "
                  "every column equals the SpMV kernel's")


def _spmm_jump_check(sysj, dev, errs):
    """Kernel #5 at the multi-RHS MGCG's CG level: the 255^3 jump operator
    as a 7-diagonal fp32 DIA (offsets +-1, +-255, +-65025), k = MULTI_K,
    against its twin; every column equals the single-RHS kernel's."""
    A = sysj.A.device_put(torch.float32, dev)
    X = torch.randn((MULTI_K, A.n), generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    Y, ref = spmm_dia_cuda(A, X), spmm_dia_ref(A, X)
    torch.cuda.synchronize()
    err, scale = _max_err(Y, ref)
    tag = f"spmm_dia {ACC_DIA7} fp32 legs"
    _require(err <= KERNEL_REL * scale, f"{tag}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
    same = all(torch.equal(Y[j], spmv_dia_cuda(A, X[j])) for j in range(MULTI_K))
    _require(same, f"{tag}: a column differs from the single-RHS kernel")
    errs["spmm_dia"] = max(errs["spmm_dia"], err)
    print(f"{tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}); every column equals the "
          "SpMV kernel's")


def _small_refine_card_vs_cpu(dev):
    """The same small refined solve on the card and on the CPU (twins)."""
    s = generators.banded_sin_system(*SMALL_REFINE)
    kw = dict(tol=FLAGSHIP_TOL, norm="l2", inner_tol=FLAGSHIP_INNER_TOL)
    g = refined_solve(s.A, s.b, s.x0, device=dev, **kw)
    c = refined_solve(s.A, s.b, s.x0, device="cpu", **kw)
    tag = f"small refined banded_sin{SMALL_REFINE}"
    _require(g.converged and c.converged, f"{tag}: card {g.converged}, CPU {c.converged}")
    _require(g.outer_iterations == c.outer_iterations,
             f"{tag}: {g.outer_iterations} outer passes on the card vs {c.outer_iterations} on the CPU")
    dx = float(np.abs(g.x - c.x).max() / np.abs(c.x).max())
    _require(dx <= MULTI_AGREE, f"{tag}: card vs CPU solution differs by {dx:.3e}")
    print(f"{tag}: card {g.outer_iterations} outer / {g.inner_iterations} inner, CPU "
          f"{c.outer_iterations} / {c.inner_iterations}, max rel diff {dx:.3e}")


def _flagship_routes(fsys, dev, card):
    """bench.py's flagship call on the card, three routes, each counted (the
    counts set to 0 just before the solve and read just after) and then
    timed in a second run.  Returns {route: launches by dtype}."""
    routes = (
        ("fp32 legs", {}, "fp32"),
        ("bf16 legs", dict(matrix_dtype=torch.bfloat16), "bf16"),
        ("fp64 device residual", dict(device_residual=True), "fp32"),
    )
    out = {}
    for label, kw, inner_tag in routes:
        solve = lambda: refined_solve(
            fsys.A, fsys.b, fsys.x0, tol=FLAGSHIP_TOL, norm="l2", inner_tol=FLAGSHIP_INNER_TOL,
            device_dtype=np.float32, device=dev, **kw)
        torch.cuda.synchronize()
        cuda_dia.reset_launch_counts()
        res = solve()
        torch.cuda.synchronize()
        counts = dict(spmv_dia_cuda.launches_by_dtype)
        tag = f"flagship {label}"
        _require(res.converged, f"{tag}: not converged after {res.outer_iterations} passes "
                                f"(stalled {res.stalled}, history {res.history})")
        _require(res.x.shape == (fsys.n,) and bool(np.isfinite(res.x).all()), f"{tag}: bad x")
        r_true = float(np.linalg.norm(fsys.b - oracle.spmv(fsys.A, res.x)))
        _require(r_true < FLAGSHIP_TOL, f"{tag}: true fp64 ||b - A x||_2 {r_true:.3e} >= {FLAGSHIP_TOL}")
        want = res.outer_iterations + res.inner_iterations
        _require(want > 0, f"{tag}: no inner solve ran")
        _require(counts.get(inner_tag, 0) == want,
                 f"{tag}: {inner_tag} SpMV launches {counts} != outer + inner iterations {want}")
        if kw.get("device_residual"):
            _require(counts.get("fp64", 0) == res.outer_iterations + 1,
                     f"{tag}: fp64 residual launches {counts} != outer passes + 1")
        print(f"{tag}: converged, {res.outer_iterations} outer / {res.inner_iterations} inner "
              f"iterations, true fp64 ||r||_2 {r_true:.3e}, history "
              f"{[float(f'{h:.4e}') for h in res.history]}, spmv_dia launches {counts}")
        _print_route_time(f"{tag} (counted run)", res.timings, card)
        _print_route_time(f"{tag} (timed run)", solve().timings, card)
        out[label] = counts
    return out


def _print_route_time(tag, timings, card):
    """A refined solve's host-clock wall (the whole call) split into inner
    solves and host outer work, from ``RefineResult.timings``."""
    wall = timings["inner_s"] + timings["outer_s"]
    print(f"time {tag}: wall {wall * 1e3:.3f} ms = inner solves {timings['inner_s'] * 1e3:.3f} ms"
          f" + host outer work {timings['outer_s'] * 1e3:.3f} ms; timings "
          f"{({k: round(v * 1e3, 3) for k, v in timings.items()})} ms [{card}]")


def _flagship_multi(fsys, dev, card) -> int:
    """``api.solve(A, B, method="refined")`` with B = [b, three seeded normal
    columns], counted; every column must converge and agree with its
    single-RHS refined solve.  Returns the SpMM launch count."""
    rng = np.random.default_rng(SEED)
    B = np.column_stack([fsys.b] + [rng.standard_normal(fsys.n) for _ in range(3)])
    torch.cuda.synchronize()
    cuda_dia.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.solve(fsys.A, B, method="refined", tol=FLAGSHIP_TOL, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm_dia_cuda.launches
    by_dtype = dict(spmm_dia_cuda.launches_by_dtype)
    tag = f"flagship multi-RHS n x {B.shape[1]}"
    _require(bool(res.converged.all()), f"{tag}: converged {res.converged}, history {res.history}")
    _require(res.x.shape == B.shape and bool(np.isfinite(res.x).all()), f"{tag}: bad X")
    _require(launches > 0, f"{tag}: no spmm_dia launch")
    worst = 0.0
    for j in range(B.shape[1]):
        r_true = float(np.linalg.norm(B[:, j] - oracle.spmv(fsys.A, res.x[:, j])))
        _require(r_true < FLAGSHIP_TOL, f"{tag} column {j}: true ||r||_2 {r_true:.3e}")
        single = refined_solve(fsys.A, B[:, j], tol=FLAGSHIP_TOL, device=dev)
        dx = float(np.abs(res.x[:, j] - single.x).max() / np.abs(single.x).max())
        _require(dx <= MULTI_AGREE, f"{tag} column {j}: differs from its single-RHS solve by {dx:.3e}")
        worst = max(worst, dx)
    print(f"{tag}: converged in {res.outer_iterations} outer passes, inner iterations per column "
          f"{res.inner_iterations.tolist()}, max rel diff to single-RHS solves {worst:.3e}, "
          f"spmm_dia launches {launches} {by_dtype} (chunks of {k_chunks(B.shape[1])})")
    print(f"time {tag}: wall {wall * 1e3:.3f} ms [{card}]")
    return launches


def _dia_times(A_host, dev, card, times):
    """Kernel vs twin at the flagship's shape (band 160, n = 207,402): the
    SpMV in three instantiations, fused vs unfused-plus-dot, the SpMM at
    k = 4 and 8 vs k single SpMVs and vs a CSR SpMM (``times`` gets (kernel,
    twin, CSR) ms; bf16 legs: the CSR holds them upcast to fp32, the same
    function); and a read/copy bandwidth canary."""
    rng = np.random.default_rng(SEED + 1)
    n = A_host.n
    xs = {v: torch.from_numpy(rng.standard_normal(n)).to(dev, v) for v in (torch.float32, torch.float64)}
    for legs in LEG_DTYPES:
        A = A_host.device_put(legs, dev)
        x = xs[torch.float64 if legs == torch.float64 else torch.float32]
        k_ms = time_ms(lambda: spmv_dia_cuda(A, x), 200)
        p_ms = time_ms(lambda: spmv_dia_ref(A, x), 10)
        gb = (A.data.numel() * A.data.element_size() + 2 * n * x.element_size()) / 1e9
        times[("spmv_dia", TAGS[legs])] = (k_ms, p_ms)
        print(f"time spmv_dia {TAGS[legs]} legs n={n} band=160: kernel {k_ms:.4f} ms "
              f"({gb / (k_ms * 1e-3):.0f} GB/s of {gb * 1e3:.1f} MB), twin {p_ms:.4f} ms [{card}]")
    A = A_host.device_put(torch.float32, dev)
    x = xs[torch.float32]
    f_ms = time_ms(lambda: spmv_dot_dia_cuda(A, x), 200)
    u_ms = time_ms(lambda: torch.dot(x, spmv_dia_cuda(A, x)), 200)
    print(f"time spmv_dot_dia fp32 fused: {f_ms:.4f} ms vs unfused SpMV + dot {u_ms:.4f} ms [{card}]")
    for legs, k in ((torch.float32, 4), (torch.float32, 8), (torch.bfloat16, 4), (torch.float64, 4)):
        Ak = A if legs == torch.float32 else A_host.device_put(legs, dev)
        vec = torch.float64 if legs == torch.float64 else torch.float32
        X = torch.from_numpy(rng.standard_normal((k, n))).to(dev, vec)
        k_ms = time_ms(lambda: spmm_dia_cuda(Ak, X), 100)
        s_ms = time_ms(lambda: [spmv_dia_cuda(Ak, X[j]) for j in range(k)], 100)
        p_ms = time_ms(lambda: spmm_dia_ref(Ak, X), 5)
        csr = _csr(DiaMatrix(Ak.data.to(vec), Ak.offsets, Ak.shape))
        Xn = X.T.contiguous()
        tag = f"spmm_dia {TAGS[legs]} legs k={k}"
        lib_ms = _library(tag, lambda: csr @ Xn, spmm_dia_cuda(Ak, X).T, card, 100)
        nbytes = dia_nnz(Ak) * Ak.data.element_size() + 2 * k * n * X.element_size()
        bound = bound_ms(nbytes, 2 * k * dia_nnz(Ak))
        times[("spmm_dia", k, TAGS[legs])] = (k_ms, p_ms, lib_ms)
        print(f"time {tag}: kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms, "
              f"{bound[0] / k_ms:.1%} of it) vs {k} single SpMVs {s_ms:.4f} ms, twin {p_ms:.4f} ms, "
              f"CSR SpMM {lib_ms:.4f} ms [{card}]")
        del csr, Xn
    buf = torch.empty(A.data.numel(), dtype=torch.float32, device=dev).normal_()
    gb = buf.numel() * 4 / 1e9
    r_ms = time_ms(lambda: buf.sum(), 100)
    c_ms = time_ms(lambda: buf.clone(), 100)
    print(f"canary {gb * 1e3:.1f} MB fp32: read (sum) {r_ms:.4f} ms = {gb / (r_ms * 1e-3):.0f} GB/s, "
          f"copy {c_ms:.4f} ms = {2 * gb / (c_ms * 1e-3):.0f} GB/s [{card}]")


def _var_hierarchy(kind, dev, grid=VAR_GRID):
    """The diffusion system of ``kind`` on ``grid`` and its Galerkin
    hierarchy on the card, with the host setup seconds by phase."""
    t0 = time.perf_counter()
    s = generators.diffusion_system(grid, kind=kind, contrast=VAR_CONTRAST, seed=SEED)
    gen_s = time.perf_counter() - t0
    h = build_hierarchy(s.A, grid, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
                        device=dev)
    setup = {"generator": gen_s, **h.setup_s}
    levels = [(lvl.grid, lvl.A.nlegs, type(lvl.A).__name__) for lvl in h.levels]
    _require(all(isinstance(lvl.A, StencilMatrix) for lvl in h.levels),
             f"{kind} {grid}: a level const-detected: {levels}")
    print(f"hierarchy {kind} {grid}: levels (grid, legs) {[l[:2] for l in levels]} + dense "
          f"{h.coarse_inv.shape[0]}; host setup s "
          f"{ {k: round(v, 3) for k, v in setup.items()} } (total {sum(setup.values()):.3f} s)")
    return s, h


def _var_kernel_checks(cases, dev, errs):
    """Kernel #3 in its three instantiations (fp32 legs, bf16 legs with fp32
    x, fp64) against its twin on the same tensors."""
    for label, A32 in cases:
        for legs in LEG_DTYPES:
            A = A32.astype(legs)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            x = torch.randn(A.grid, device=dev, dtype=vec)
            err, scale = _max_err(spmv_stencil_cuda(A, x), spmv_stencil_ref(A, x))
            torch.cuda.synchronize()
            tag = f"{label} {TAGS[legs]} legs"
            _require(err <= rel * scale, f"spmv_stencil {tag}: max err {err:.3e} > {rel}*{scale:.3e}")
            errs["spmv_stencil"] = max(errs["spmv_stencil"], err)
            print(f"spmv_stencil {tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e})")
            del A, x


def _small_var_mgcg_card_vs_cpu(dev):
    """The default (Galerkin) MGCG route of ``api.solve`` on a small jump
    system, on the card and on the CPU (twins): equal iteration counts."""
    s = generators.diffusion_system(VAR_SMALL, kind="jump", contrast=VAR_CONTRAST, seed=SEED)
    kw = dict(method="mgcg", grid=VAR_SMALL, tol=TOL, norm="rel_l2", dtype=np.float32,
              precise_dot=True)
    g = api.solve(s.A, s.b, device=dev, **kw)
    c = api.solve(s.A, s.b, device="cpu", **kw)
    tag = f"small Galerkin MGCG jump {VAR_SMALL}"
    _require(g.converged and c.converged, f"{tag}: card {g.converged}, CPU {c.converged}")
    _require(g.iterations == c.iterations,
             f"{tag}: {g.iterations} iterations on the card vs {c.iterations} on the CPU")
    dx = float((g.x.cpu() - c.x).abs().max() / c.x.abs().max())
    _require(dx <= SMALL_AGREE, f"{tag}: card vs CPU solution differs by {dx:.3e}")
    print(f"{tag}: card {g.iterations} its, CPU {c.iterations} its, max rel diff {dx:.3e}")


def _host_rel_residual(A, b, x) -> float:
    """||b - A x||_2 / ||b||_2 in fp64 by the host oracle."""
    r = b - oracle.spmv(A, np.asarray(x, dtype=np.float64))
    return float(np.linalg.norm(r) / np.linalg.norm(b))


def _var_mgcg(sysj, hj, dev, card):
    """``api.solve(method="mgcg")`` on the 255^3 jump system over its
    Galerkin hierarchy, counted (kernel #3 at every level), timed in a warm
    run, then profiled.  Returns kernel #3's launch count, the counted result
    and the warm wall (ms)."""
    kw = dict(method="mgcg", grid=VAR_GRID, tol=TOL, norm="rel_l2", dtype=np.float32, device=dev,
              hierarchy=hj, precise_dot=True)
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    t0 = time.perf_counter()
    res = api.solve(sysj.A, sysj.b, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = spmv_stencil_cuda.launches
    by_grid = dict(spmv_stencil_cuda.launches_by_grid)
    by_dtype = dict(spmv_stencil_cuda.launches_by_dtype)
    tag = f"MGCG jump {VAR_GRID}"
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    _require(tuple(res.x.shape) == (sysj.n,) and bool(torch.isfinite(res.x).all()), f"{tag}: bad x")
    rel = _host_rel_residual(sysj.A, sysj.b, res.x.cpu().numpy())
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    for lvl in hj.levels:
        _require(by_grid.get(lvl.grid, 0) > 0, f"spmv_stencil: no launch at level {lvl.grid}")
    _require(set(by_dtype) == {"fp32"}, f"{tag}: kernel #3 launches by leg dtype {by_dtype}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.solve(sysj.A, sysj.b, **kw)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag}: {res.iterations} iterations, rel_l2 {float(res.residual):.3e}, true fp64 rel "
          f"residual {rel:.3e}; spmv_stencil launches {launches} by grid "
          f"{ {str(k): v for k, v in sorted(by_grid.items(), reverse=True)} }")
    print(f"time {tag} api.solve: counted run {first_ms:.3f} ms, warm run {warm_ms:.3f} ms [{card}]")
    _device_time_top(lambda: api.solve(sysj.A, sysj.b, **kw), warm_ms, card)
    return launches, res, warm_ms


def _var_refine_routes(syss, hs, dev, card) -> int:
    """``refined_solve(grid=, matrix_dtype=bf16)`` on the 255^3 smooth
    system, host and device residual, each counted, the device route then
    timed in a second run.  Returns kernel #3's launch count over both
    counted runs, the host-residual route's result and the device route's
    timed wall (ms)."""
    total, results = 0, {}
    for label, kw in (("host residual", {}), ("device residual", dict(device_residual=True))):
        solve = lambda: refined_solve(
            syss.A, syss.b, tol=FLAGSHIP_TOL, norm="l2", grid=SMOOTH_GRID,
            inner_tol=FLAGSHIP_INNER_TOL, matrix_dtype=torch.bfloat16, hierarchy=hs, device=dev, **kw)
        torch.cuda.synchronize()
        cuda_stencil.reset_launch_counts()
        cuda_dia.reset_launch_counts()
        res = solve()
        torch.cuda.synchronize()
        by_dtype = dict(spmv_stencil_cuda.launches_by_dtype)
        by_grid = dict(spmv_stencil_cuda.launches_by_grid)
        dia = dict(spmv_dia_cuda.launches_by_dtype)
        total += spmv_stencil_cuda.launches
        tag = f"refined smooth {SMOOTH_GRID} bf16 legs, {label}"
        _require(res.converged, f"{tag}: not converged after {res.outer_iterations} passes "
                                f"(stalled {res.stalled}, history {res.history})")
        _require(res.x.shape == (syss.n,) and bool(np.isfinite(res.x).all()), f"{tag}: bad x")
        r_true = float(np.linalg.norm(syss.b - oracle.spmv(syss.A, res.x)))
        _require(r_true < FLAGSHIP_TOL, f"{tag}: true fp64 ||b - A x||_2 {r_true:.3e} >= {FLAGSHIP_TOL}")
        want = res.outer_iterations + res.inner_iterations
        _require(want > 0 and by_dtype.get("bf16", 0) == want,
                 f"{tag}: bf16-leg launches {by_dtype} != outer + inner iterations {want}")
        for lvl in hs.levels:
            _require(by_grid.get(lvl.grid, 0) > 0, f"{tag}: no kernel #3 launch at level {lvl.grid}")
        if kw.get("device_residual"):
            _require(dia.get("fp64", 0) == res.outer_iterations + 1,
                     f"{tag}: fp64 residual launches {dia} != outer passes + 1")
        print(f"{tag}: converged, {res.outer_iterations} outer / {res.inner_iterations} inner "
              f"iterations, true fp64 ||r||_2 {r_true:.3e}, history "
              f"{[float(f'{v:.4e}') for v in res.history]}, spmv_stencil launches {by_dtype}, "
              f"spmv_dia {dia}")
        _print_route_time(f"{tag} (counted run)", res.timings, card)
        if kw.get("device_residual"):  # the host route's wall is its host residual's: run once
            timings = solve().timings
            _print_route_time(f"{tag} (timed run)", timings, card)
            device_wall_ms = (timings["inner_s"] + timings["outer_s"]) * 1e3
        results[label] = res
    return total, results["host residual"], device_wall_ms


def _var_times(hj, dev, card, times):
    """Kernel #3 vs its twin at the path's shapes: the 255^3 fine level
    (7 legs; fp32, bf16 and fp64 legs) and the 127^3 Galerkin level (27
    legs; fp32 and bf16), with GB/s from all leg bytes + x + y and the
    share of the bound (the leg entries whose neighbour lies in the grid)."""
    for label, A32, dtypes in (("255^3 7 legs", hj.levels[0].A, LEG_DTYPES),
                               ("127^3 27 legs", hj.levels[1].A, (torch.float32, torch.bfloat16))):
        for legs in dtypes:
            A = A32.astype(legs)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            x = torch.randn(A.grid, device=dev, dtype=vec)
            k_ms = time_ms(lambda: spmv_stencil_cuda(A, x), 50)
            p_ms = time_ms(lambda: spmv_stencil_ref(A, x), 10)
            gb = (A.data.numel() * A.data.element_size() + 2 * x.numel() * x.element_size()) / 1e9
            bound = bound_ms(A.nnz * A.data.element_size() + 2 * x.numel() * x.element_size(),
                             2 * A.nnz)
            times[("spmv_stencil", label, TAGS[legs])] = (k_ms, p_ms)
            print(f"time spmv_stencil {label} {TAGS[legs]} legs: kernel {k_ms:.4f} ms "
                  f"({gb / (k_ms * 1e-3):.0f} GB/s of {gb * 1e3:.1f} MB; bound {bound[0]:.4f} ms, "
                  f"{bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms [{card}]")
            del A, x


def _nan_carved(X):
    """A copy of ``X`` (k, n) carved out of a NaN-filled buffer, with NaNs
    planted at both ends of every column: a read past [0, n) or a leg that
    is not skipped where its neighbour lies outside would leak a NaN where
    the twin has none."""
    pad = 4096
    buf = torch.full((X.numel() + 2 * pad,), float("nan"), device=X.device)
    Xc = buf[pad : pad + X.numel()].view(X.shape)
    Xc.copy_(X)
    Xc[:, 0] = float("nan")
    Xc[:, -1] = float("nan")
    return Xc


def _acc_kernel_checks(dev, errs):
    """Kernel #6 against its twin, against kernel #5 and against the fp64
    oracle (on the legs as the kernel reads them), fp32 and bf16 legs, k in
    SPMM_KS, then on a NaN-planted X: equal NaN patterns, the rows the band
    does not reach finite."""
    rng = np.random.default_rng(SEED + 2)
    for label, n, band in ACC_CASES:
        A_host = generators.banded_sin_matrix(n, band)
        for legs in (torch.float32, torch.bfloat16):
            A = A_host.device_put(legs, dev)
            A64 = DiaMatrix(A.data.double().cpu().numpy(), A.offsets, A.shape)
            tag = f"spmm_dia_acc {label} {TAGS[legs]} legs"
            worst = worst5 = worst_o = 0.0
            for k in SPMM_KS:
                X = torch.from_numpy(rng.standard_normal((k, n))).to(dev, torch.float32)
                Y, ref, Y5 = spmm_dia_acc_cuda(A, X), spmm_dia_acc_ref(A, X), spmm_dia_cuda(A, X)
                torch.cuda.synchronize()
                err, scale = _max_err(Y, ref)
                _require(err <= KERNEL_REL * scale, f"{tag} k={k}: max err {err:.3e} > {KERNEL_REL}*{scale:.3e}")
                e5, s5 = _max_err(Y, Y5)
                _require(e5 <= ACC_VS_SPMM * s5,
                         f"{tag} k={k}: vs spmm_dia {e5:.3e} > {ACC_VS_SPMM}*{s5:.3e}")
                Yh, Xh = Y.cpu().numpy(), X.cpu().double().numpy()
                for j in range(k):
                    yo = oracle.spmv(A64, Xh[j])
                    eo = float(np.abs(Yh[j] - yo).max() / np.abs(yo).max())
                    _require(eo <= ACC_VS_ORACLE, f"{tag} k={k} column {j}: vs fp64 oracle {eo:.3e}")
                    worst_o = max(worst_o, eo)
                worst, worst5 = max(worst, err), max(worst5, e5 / s5)
            nans = []
            for k in ACC_NAN_KS:
                Xc = _nan_carved(torch.from_numpy(rng.standard_normal((k, n))).to(dev, torch.float32))
                Y, ref = spmm_dia_acc_cuda(A, Xc), spmm_dia_acc_ref(A, Xc)
                torch.cuda.synchronize()
                nan = torch.isnan(ref)
                _require(torch.equal(torch.isnan(Y), nan) and 0 < int(nan.sum()) < nan.numel(),
                         f"{tag} k={k}: NaN pattern differs from the twin's (or is all or nothing)")
                err, scale = _max_err(Y[~nan], ref[~nan])
                _require(err <= KERNEL_REL * scale, f"{tag} k={k} NaN-planted: max err {err:.3e}")
                worst = max(worst, err)
                nans.append(int(nan.sum()))
            errs["spmm_dia_acc"] = max(errs["spmm_dia_acc"], worst)
            print(f"{tag} k={SPMM_KS}: max|kernel-twin| {worst:.3e}, vs spmm_dia {worst5:.3e} of "
                  f"max|Y|, vs fp64 oracle {worst_o:.3e}; NaN-planted X at k={ACC_NAN_KS}: {nans} NaN "
                  "entries, the same as the twin's")


def _acc_experiment(sysj, dev):
    """The experiment at its default shape, counted: the path of kernel #6.
    Then its measurement on the 255^3 7-diagonal DIA at k = MULTI_K.
    Returns kernel #6's launch count in the counted run and the two records
    (kernels #6 and #5 timed at each shape), keyed as ``_acc_times``."""
    torch.cuda.synchronize()
    cuda_dia.reset_launch_counts()
    rec = spmm_acc_experiment.run()
    torch.cuda.synchronize()
    launches, by_dtype = spmm_dia_acc_cuda.launches, dict(spmm_dia_acc_cuda.launches_by_dtype)
    _require(rec["max_rel_err"] < ACC_VS_ORACLE, f"spmm_acc_experiment: {rec}")
    _require(launches > 0, "spmm_acc_experiment: no spmm_dia_acc launch")
    rec7 = spmm_acc_experiment.measure(sysj.A, MULTI_K, dev)
    _require(rec7["max_rel_err"] < ACC_VS_ORACLE, f"spmm_acc_experiment 255^3: {rec7}")
    print(f"spmm_acc_experiment on the 255^3 7-diagonal DIA: {json.dumps(rec7)}")
    print(f"spmm_acc_experiment default shape (counted): spmm_dia_acc launches {launches} {by_dtype}")
    return launches, {ACC_MAIN: rec, ACC_DIA7: rec7}


def _counts():
    """The launch counts of kernels #1, #2, #3 and #5."""
    return {"spmv_const_stencil": spmv_const_stencil_cuda.launches,
            "cheb_smooth_const": cheb_smooth_const_cuda.launches,
            "spmv_stencil": spmv_stencil_cuda.launches, "spmm_dia": spmm_dia_cuda.launches}


def _reset_counts():
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    cuda_dia.reset_launch_counts()


def _wide_launch_dims(h):
    """{(launch grid, block) of the wide #3 on a level of ``h``: that
    level's grid}, from the launch ``wide_geometry`` gives each."""
    out = {}
    for lvl in h.levels:
        A = lvl.A
        if isinstance(A, StencilMatrix) and var_route(A) == "wide":
            geo = wide_geometry(wide_view(tuple(A.grid), tuple(A.shifts)), A.nlegs,
                                cuda_stencil._sms(A.data.device.index))
            out[(geo.grid, (geo.block[0], geo.block[1] * geo.split, 1))] = str(lvl.grid)
    return out


def _wide_by_grid(prof, h):
    """The wide #3's device time (ms) and launches in a profile, by the
    level of ``h`` each launch's grid and block dims belong to (read from
    the trace's kernel events)."""
    dims = _wide_launch_dims(h)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    out = collections.defaultdict(lambda: [0.0, 0])
    for e in events:
        if e.get("cat") == "kernel" and "spmv_var_wide_kernel" in e.get("name", ""):
            args = e.get("args", {})
            key = (tuple(args.get("grid", ())), tuple(args.get("block", ())))
            row = out[dims.get(key, f"unmatched {key}")]
            row[0] += e.get("dur", 0.0) / 1e3
            row[1] += 1
    return {k: [round(ms, 4), n] for k, (ms, n) in sorted(out.items())}


def _device_time_top(fn, wall_ms: float, card, top: int = 6, h=None):
    """Run ``fn`` once under ``torch.profiler`` and print the device time by
    kernel name (the ``top`` largest) beside the profiled wall, and the
    device's busy share of ``wall_ms``, the same work's unprofiled wall;
    with a hierarchy ``h``, the wide #3's device time by level too."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    prof_ms = (time.perf_counter() - t0) * 1e3
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    # device events only: a CPU op's self device time repeats its kernels'
    rows = sorted(((dev_us(e), e.count, e.key) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and dev_us(e) > 0),
                  reverse=True)
    total_ms = sum(r[0] for r in rows) / 1e3
    wide = "" if h is None else f"; wide #3 device [ms, launches] by grid {_wide_by_grid(prof, h)}"
    print(f"profile: profiled wall {prof_ms:.3f} ms, device time {total_ms:.3f} ms in "
          f"{sum(r[1] for r in rows)} device ops, device busy {total_ms / wall_ms:.1%} of the "
          f"unprofiled wall {wall_ms:.3f} ms; top: "
          f"{[(k[:60], round(us / 1e3, 3), n) for us, n, k in rows[:top]]}{wide} [{card}]")


def _multi_mgcg(sysj, hj, single, dev, card):
    """Multi-RHS MGCG on the 255^3 jump system: ``cg_solve_multi`` on its
    fp32 DIA (kernel #5 at the CG level) with ``as_multi_preconditioner``
    over its hierarchy (kernel #3 per column at every level), k = MULTI_K,
    column 0 the system's b; counted, then the whole solve profiled.
    Column 0 must take the single-RHS solve's iterations and agree with its
    solution.  Returns the launch counts and the counted wall (ms)."""
    rng = np.random.default_rng(SEED)
    B = np.column_stack([sysj.b] + [rng.standard_normal(sysj.n) for _ in range(MULTI_K - 1)])
    A_dev = sysj.A.device_put(torch.float32, dev)
    B_dev = torch.from_numpy(B).to(dev, torch.float32)
    M = as_multi_preconditioner(hj)
    policy = ConvergencePolicy(tol=TOL, norm="rel_l2")
    _reset_counts()
    t0 = time.perf_counter()
    res = cg_solve_multi(A_dev, B_dev, policy=policy, M=M)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    by_grid = dict(spmv_stencil_cuda.launches_by_grid)
    its = res.iterations.tolist()
    tag = f"multi-RHS MGCG jump {VAR_GRID} k={MULTI_K}"
    _require(bool(res.converged.all()), f"{tag}: converged {res.converged.tolist()}, its {its}")
    _require(its[0] == single.iterations,
             f"{tag}: column 0 took {its[0]} iterations, the single-RHS solve {single.iterations}")
    _require(tuple(res.x.shape) == B.shape and bool(torch.isfinite(res.x).all()), f"{tag}: bad X")
    X = res.x.cpu().numpy()
    rels = [_host_rel_residual(sysj.A, B[:, j], X[:, j]) for j in range(MULTI_K)]
    _require(max(rels) <= TRUE_REL, f"{tag}: true fp64 relative residuals {rels} > {TRUE_REL}")
    x1 = single.x.cpu().numpy()
    dx = float(np.abs(X[:, 0] - x1).max() / np.abs(x1).max())
    _require(dx <= SMALL_AGREE, f"{tag}: column 0 differs from the single-RHS solution by {dx:.3e}")
    for lvl in hj.levels:
        _require(by_grid.get(lvl.grid, 0) > 0, f"{tag}: no kernel #3 launch at level {lvl.grid}")
    _require(counts["spmm_dia"] == max(its) + 1,
             f"{tag}: spmm_dia launches {counts['spmm_dia']} != iterations + 1 ({max(its) + 1})")
    print(f"{tag}: iterations per column {its} (single-RHS {single.iterations}), true fp64 rel "
          f"residuals {[float(f'{r:.3e}') for r in rels]}, column 0 vs single-RHS {dx:.3e}; "
          f"launches {counts}, kernel #3 by grid "
          f"{ {str(k): v for k, v in sorted(by_grid.items(), reverse=True)} }")
    print(f"time {tag}: counted run {wall_ms:.3f} ms [{card}]")
    _device_time_top(lambda: cg_solve_multi(A_dev, B_dev, policy=policy, M=M), wall_ms, card)
    return counts, wall_ms


def _facade_multi_mgcg(dev, card):
    """``api.solve(B, method="mgcg")`` on 63^3 Poisson (Galerkin levels that
    const-detect: the fused smoother, kernel #2, per column, with its own
    residual, so kernel #1 stays idle; #5 at the CG level),
    k = MULTI_K, on the card (counted) and on the CPU: equal per-column
    iterations."""
    s = generators.poisson_system(FACADE_GRID, dtype=np.float32)
    rng = np.random.default_rng(SEED + 3)
    B = np.column_stack([s.b] + [rng.standard_normal(s.n) for _ in range(MULTI_K - 1)])
    kw = dict(method="mgcg", grid=FACADE_GRID, tol=TOL, norm="rel_l2", dtype=np.float32)
    _reset_counts()
    t0 = time.perf_counter()
    g = api.solve(s.A, B, device=dev, **kw)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    counts = _counts()
    c = api.solve(s.A, B, device="cpu", **kw)
    tag = f"facade multi-RHS mgcg Poisson {FACADE_GRID} k={MULTI_K}"
    _require(bool(g.converged.all()) and bool(c.converged.all()),
             f"{tag}: card {g.converged.tolist()}, CPU {c.converged.tolist()}")
    _require(g.iterations.tolist() == c.iterations.tolist(),
             f"{tag}: iterations {g.iterations.tolist()} on the card vs {c.iterations.tolist()} on the CPU")
    dx = float((g.x.cpu() - c.x).abs().max() / c.x.abs().max())
    _require(dx <= SMALL_AGREE, f"{tag}: card vs CPU solution differs by {dx:.3e}")
    for name in ("cheb_smooth_const", "spmm_dia"):  # the fused smoother leaves #1 idle
        _require(counts[name] > 0, f"{tag}: no {name} launch ({counts})")
    print(f"{tag}: card {g.iterations.tolist()} its, CPU {c.iterations.tolist()} its, max rel diff "
          f"{dx:.3e}; launches {counts}")
    print(f"time {tag} api.solve (card, hierarchy setup included): {wall_ms:.3f} ms [{card}]")
    return counts


def _refine_multi(syss, hs, single, dev, card):
    """``refined_solve_multi(grid=, hierarchy=, matrix_dtype=bf16)`` on the
    255^3 smooth system, k = REFINE_MULTI_K, column 0 its b, counted: every
    column reaches ||r||_2 < 1e-8, and column 0's outer passes and inner
    iterations equal the single-RHS host route's."""
    rng = np.random.default_rng(SEED + 4)
    B = np.column_stack([syss.b] + [rng.standard_normal(syss.n) for _ in range(REFINE_MULTI_K - 1)])
    _reset_counts()
    t0 = time.perf_counter()
    res = refined_solve_multi(syss.A, B, tol=FLAGSHIP_TOL, norm="l2", grid=SMOOTH_GRID,
                              inner_tol=FLAGSHIP_INNER_TOL, matrix_dtype=torch.bfloat16,
                              hierarchy=hs, device=dev)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    by_dtype = dict(spmv_stencil_cuda.launches_by_dtype)
    tag = f"refined multi-RHS smooth {SMOOTH_GRID} bf16 legs k={REFINE_MULTI_K}"
    _require(bool(res.converged.all()), f"{tag}: converged {res.converged}, history {res.history}")
    _require(res.x.shape == B.shape and bool(np.isfinite(res.x).all()), f"{tag}: bad X")
    r_true = [float(np.linalg.norm(B[:, j] - oracle.spmv(syss.A, res.x[:, j])))
              for j in range(REFINE_MULTI_K)]
    _require(max(r_true) < FLAGSHIP_TOL, f"{tag}: true fp64 ||r||_2 {r_true} >= {FLAGSHIP_TOL}")
    outer0 = next(p for p, h in enumerate(res.history) if h[0] < FLAGSHIP_TOL)
    inner0 = int(res.inner_iterations[0])
    _require((outer0, inner0) == (single.outer_iterations, single.inner_iterations),
             f"{tag}: column 0 took {outer0} outer / {inner0} inner, the single-RHS host route "
             f"{single.outer_iterations} / {single.inner_iterations}")
    _require(by_dtype.get("bf16", 0) > 0, f"{tag}: no bf16-leg kernel #3 launch ({by_dtype})")
    print(f"{tag}: converged in {res.outer_iterations} outer passes, inner iterations per column "
          f"{res.inner_iterations.tolist()}, column 0 {outer0} outer / {inner0} inner (single-RHS "
          f"{single.outer_iterations} / {single.inner_iterations}), true fp64 ||r||_2 "
          f"{[float(f'{r:.3e}') for r in r_true]}; spmv_stencil launches {by_dtype}")
    print(f"time {tag}: wall {wall_s * 1e3:.3f} ms [{card}]")
    return _counts()


def _csr(A):
    """A device DIA matrix as a CSR tensor with int32 indices, built on the
    card: each row's in-range entries, offsets ascending."""
    n = A.n
    order = sorted(range(A.ndiags), key=lambda k: A.offsets[k])
    offs = torch.tensor([A.offsets[k] for k in order], device=A.data.device)
    cols = torch.arange(n, device=offs.device)[:, None] + offs[None, :]
    keep = (cols >= 0) & (cols < n)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=offs.device)
    crow[1:] = torch.cumsum(keep.sum(1), 0)
    vals = A.data[order].T[keep]
    return torch.sparse_csr_tensor(crow.int(), cols[keep].int(), vals, size=(n, n),
                                   check_invariants=False)


def _library(name, lib_fn, kernel_out, card, reps):
    """Time one PyTorch call (the yardstick) after checking that it computes
    what the kernel computed."""
    err, scale = _max_err(lib_fn(), kernel_out)
    _require(err <= KERNEL_REL * scale, f"library call for {name}: max err {err:.3e} vs the kernel")
    ms = time_ms(lib_fn, reps)
    print(f"time library call for {name}: {ms:.4f} ms (max|library-kernel| {err:.3e}) [{card}]")
    return ms


def _library_and_bounds(ops, fsys, sysj, hj, dev, card, times):
    """For the main shape of kernels #1-#5: the library call's time and the
    bound.  #1 at 255^3 (cuDNN ``conv3d``), #2 degree-2 pre-smooth at 255^3
    (no library call), #3 the 255^3 jump fine level (cuSPARSE CSR SpMV), #4
    band 160 fp32 (CSR SpMV), #5 band 160 k = 4 (CSR SpMM, from
    ``_dia_times``)."""
    lib, bounds = {}, {}
    A1 = ops[GRID_3D]
    n3 = int(np.prod(GRID_3D))
    x = torch.randn(GRID_3D, device=dev)
    lib["spmv_const_stencil"] = _library("spmv_const_stencil 255^3", _conv(A1, x),
                                         spmv_const_stencil_cuda(A1, x), card, 50)
    bounds["spmv_const_stencil"] = bound_ms(2 * n3 * 4, 2 * A1.nlegs * n3)
    lib["cheb_smooth_const"] = None
    bounds["cheb_smooth_const"] = bound_ms(_cheb_bytes(n3, True, True),
                                           _cheb_flops(A1.nlegs, 2, True, True) * n3)
    A3 = hj.levels[0].A
    csr = _csr(sysj.A.device_put(torch.float32, dev))
    lib["spmv_stencil"] = _library("spmv_stencil 255^3 7 legs fp32", lambda: csr @ x.reshape(-1),
                                   spmv_stencil_cuda(A3, x).reshape(-1), card, 50)
    bounds["spmv_stencil"] = bound_ms(A3.nnz * 4 + 2 * n3 * 4, 2 * A3.nnz)
    del csr
    A = fsys.A.device_put(torch.float32, dev)
    nnz = dia_nnz(A)
    csr = _csr(A)
    xf = torch.randn(A.n, device=dev)
    lib["spmv_dia"] = _library("spmv_dia band 160 fp32", lambda: csr @ xf, spmv_dia_cuda(A, xf),
                               card, 200)
    bounds["spmv_dia"] = bound_ms(spmm_bytes(A, 1), 2 * nnz)
    lib["spmm_dia"] = times[("spmm_dia", 4, "fp32")][2]
    bounds["spmm_dia"] = bound_ms(spmm_bytes(A, 4), 2 * 4 * nnz)
    return lib, bounds


def _acc_times(sysj, recs, dev, card, times, lib, bounds):
    """Kernel #6 against its twin and cuSPARSE's CSR SpMM, each time beside
    kernel #5's on the same inputs and the bound: at the experiment's shape
    (n = 414,720, band 160, k = 8; the record's main shape) in fp32 legs and
    on the 255^3 7-diagonal DIA at k = MULTI_K, both timed by the
    experiment (``recs``), then the same main shape with bf16 legs and the
    flagship band 160 at k = 4, timed here (bf16 legs: the CSR holds them
    upcast to fp32, the same function)."""
    main = generators.banded_sin_matrix(414_720, 160, np.float32)
    cases = ((ACC_MAIN, main, torch.float32, 8), (ACC_DIA7, sysj.A, torch.float32, MULTI_K),
             (ACC_MAIN_BF16, main, torch.bfloat16, 8),
             (ACC_FLAGSHIP, generators.banded_sin_matrix(207_402, 160, np.float32), torch.float32, 4))
    for label, A_host, legs, k in cases:
        A = A_host.device_put(legs, dev)
        X = torch.randn((k, A.n), device=dev)
        Xn = X.T.contiguous()
        csr = _csr(DiaMatrix(A.data.float(), A.offsets, A.shape))
        if label in recs:
            acc_ms, spmm_ms = recs[label]["single_call_us"] / 1e3, recs[label]["chained_us"] / 1e3
            src = "the experiment's record"
        else:
            acc_ms = time_ms(lambda: spmm_dia_acc_cuda(A, X), 100)
            spmm_ms = time_ms(lambda: spmm_dia_cuda(A, X), 100)
            src = "timed here"
        p_ms = time_ms(lambda: spmm_dia_acc_ref(A, X), 3)
        csr_ms = _library(f"spmm_dia_acc {label}", lambda: csr @ Xn, spmm_dia_acc_cuda(A, X).T,
                          card, 100)
        nbytes = spmm_bytes(A, k)
        bound = bound_ms(nbytes, 2 * k * dia_nnz(A))
        times[("spmm_dia_acc", label)] = (acc_ms, p_ms)
        print(f"time spmm_dia_acc {label}: kernel #6 {acc_ms:.4f} ms ({bound[0] / acc_ms:.1%} of the "
              f"bound), kernel #5 {spmm_ms:.4f} ms ({src}), CSR SpMM {csr_ms:.4f} ms, twin "
              f"{p_ms:.4f} ms, bound {bound[0]:.4f} ms ({nbytes / 1e6:.1f} MB) [{card}]")
        if label == ACC_MAIN:
            lib["spmm_dia_acc"], bounds["spmm_dia_acc"] = csr_ms, bound
        del A, X, Xn, csr


def _acc_geometry(card):
    """Kernel #6's launch at its main shapes: the library's tile and window
    ring, each instantiation's registers, blocks per SM (registers and the
    windows' shared memory) and the waves of the grid."""
    lib = _build.load("dia")
    tile, stages = lib.cg_spmm_dia_acc_tile(), lib.cg_spmm_dia_acc_stages()
    for legs, k in (("f", 8), ("13__nv_bfloat16", 8), ("f", 4)):
        n = 414_720 if k == 8 else 207_402
        geo = cuda_dia.acc_geometry(tuple(range(-79, 80)), n, k, tile, stages)
        res = next(r for e, r in _build.kernel_resources("dia").items()
                   if e.startswith(f"_Z19spmm_dia_acc_kernelI{legs}Li{k}E"))
        per_sm = blocks_per_sm(res["registers"], tile, geo.smem_bytes)
        print(f"spmm_dia_acc geometry n={n} band=160 k={k} {'fp32' if legs == 'f' else 'bf16'} legs: "
              f"{geo.blocks} blocks of {tile} rows ({geo.interior} interior), {res['registers']} "
              f"registers, {geo.smem_bytes} B shared memory ({stages} window buffers), {per_sm} "
              f"blocks per SM, "
              f"{geo.blocks / (SMS * per_sm):.2f} waves [{card}]")


# ---------------------------------------------------------------------------
# the rest of the multigrid build: hybrid, semicoarsening and aggregation
# transfers, the wide kernel #3, DIA levels, rbgs, W-cycle and fmg
# ---------------------------------------------------------------------------


def _kind_system(kind, grid):
    """Poisson, the reference's (2, 1) tridiagonal, or anisotropic diffusion
    with the axis-0 coupling at KIND_RATIOS[0], in the generators' fp64 (the
    hierarchies are built from it, their levels cast to the solve's dtype,
    as the JAX package builds them)."""
    if kind == "poisson":
        return generators.poisson_system(grid)
    if kind == "tridiagonal":
        return generators.tridiagonal_system(grid[0])
    return generators.anisotropic_diffusion_system(grid, KIND_RATIOS)


def _describe(h):
    """(grid, transfer, operator, legs, max |shift|) of each level."""
    out = []
    for lvl in h.levels:
        A = lvl.A
        if isinstance(A, DiaMatrix):
            out.append((lvl.grid, lvl.transfer, "dia", A.ndiags))
        else:
            out.append((lvl.grid, lvl.transfer,
                        "const" if isinstance(A, ConstStencilMatrix) else "var", A.nlegs, max(A.halo)))
    return out


def _kind_hierarchy(label, s, grid, dev, dtype=np.float32, **kw):
    """``build_hierarchy`` on the card, its levels and host setup by phase
    printed."""
    t0 = time.perf_counter()
    h = build_hierarchy(s.A, grid, dtype=dtype, device=dev, **kw)
    total = time.perf_counter() - t0
    print(f"hierarchy {label}: levels (grid, transfer, operator, legs, max |shift|) {_describe(h)} "
          f"+ dense {h.coarse_inv.shape[0]}; host setup s "
          f"{ {k: round(v, 3) for k, v in h.setup_s.items()} } (total {total:.3f} s)")
    return h


def _kind_counts():
    """The launch counts of every kernel a multigrid path reaches (#1-#4 and
    the wide #3)."""
    return {"spmv_const_stencil": spmv_const_stencil_cuda.launches,
            "cheb_smooth_const": cheb_smooth_const_cuda.launches,
            "spmv_stencil": spmv_stencil_cuda.launches,
            "spmv_stencil_wide": spmv_stencil_wide_cuda.launches,
            "spmv_dia": spmv_dia_cuda.launches}


def _levels_launched(tag, h):
    """Each level's own kernel launched at its grid: #1 or #2 on a const
    level, the tuned or the wide #3 on a variable one, #4 on a DIA one."""
    for lvl in h.levels:
        A = lvl.A
        if isinstance(A, DiaMatrix):
            ok, name = spmv_dia_cuda.launches_by_shape.get((A.n, A.ndiags), 0) > 0, "spmv_dia"
        elif isinstance(A, ConstStencilMatrix):
            ok = (spmv_const_stencil_cuda.launches_by_grid.get(lvl.grid, 0)
                  + cheb_smooth_const_cuda.launches_by_grid.get(lvl.grid, 0)) > 0
            name = "spmv_const_stencil or cheb_smooth_const"
        elif var_route(A) == "wide":
            ok, name = spmv_stencil_wide_cuda.launches_by_grid.get(lvl.grid, 0) > 0, "spmv_stencil_wide"
        else:
            ok, name = spmv_stencil_cuda.launches_by_grid.get(lvl.grid, 0) > 0, "spmv_stencil"
        _require(ok, f"{tag}: no {name} launch at level {lvl.grid}")


def _kind_mgcg(tag, s, grid, h, dev, card, dtype=np.float32, profile=True, **kw):
    """``api.solve(method="mgcg")`` over ``h``, counted (every level's
    kernel must launch), then timed warm and profiled.  fp32: rel_l2 TOL
    with ``precise_dot``, true fp64 relative residual within TRUE_REL; fp64
    (``dtype=None``): FP64_TOL and FP64_TRUE_REL.  Returns the launch
    counts by kernel and the result."""
    fp32 = dtype == np.float32
    kw = dict(method="mgcg", grid=grid, tol=TOL if fp32 else FP64_TOL, norm="rel_l2", dtype=dtype,
              device=dev, hierarchy=h, precise_dot=fp32, **kw)
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(s.A, s.b, **kw)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    counts = _kind_counts()
    wide = {str(k): v for k, v in sorted(spmv_stencil_wide_cuda.launches_by_grid.items(), reverse=True)}
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    _require(tuple(res.x.shape) == (s.n,) and bool(torch.isfinite(res.x).all()), f"{tag}: bad x")
    rel = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
    bound = TRUE_REL if fp32 else FP64_TRUE_REL
    _require(rel <= bound, f"{tag}: true fp64 relative residual {rel:.3e} > {bound}")
    _levels_launched(tag, h)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    api.solve(s.A, s.b, **kw)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"{tag}: {res.iterations} iterations, rel_l2 {float(res.residual):.3e}, true fp64 rel "
          f"residual {rel:.3e}; launches by kernel {counts}; wide kernel #3 by grid {wide}")
    print(f"time {tag} api.solve: counted run {first_ms:.3f} ms, warm run {warm_ms:.3f} ms [{card}]")
    if profile:
        _device_time_top(lambda: api.solve(s.A, s.b, **kw), warm_ms, card, h=h)
    return counts, res


def _kind_small_card_vs_cpu(dev):
    """KIND_SMALL's solves in fp64 (dtype=None) to FP64_TOL, on the card and
    on the CPU over the same host-built hierarchy: equal converged flags and
    iteration counts.  Returns the card's 64^3 Galerkin hierarchy (its 16^3
    level has 125 legs)."""
    out = None
    for label, kind, grid, kw, gamma in KIND_SMALL:
        s = _kind_system(kind, grid)
        bkw = dict(coarse_operator=generators.poisson_coarse_operator()) if kw == "redisc" else kw
        h_cpu = build_hierarchy(s.A, grid, device="cpu", **bkw)
        h_dev = copy.deepcopy(h_cpu).to(dev)
        skw = dict(method="mgcg", grid=grid, tol=FP64_TOL, norm="rel_l2", gamma=gamma)
        _reset_counts()
        g = api.solve(s.A, s.b, hierarchy=h_dev, device=dev, **skw)
        torch.cuda.synchronize()
        counts = {k: v for k, v in _kind_counts().items() if v}
        _levels_launched(f"small {label}", h_dev)
        c = api.solve(s.A, s.b, hierarchy=h_cpu, device="cpu", **skw)
        tag = f"small {label} fp64"
        _require(g.converged and c.converged, f"{tag}: card {g.converged}, CPU {c.converged}")
        _require(g.iterations == c.iterations,
                 f"{tag}: {g.iterations} iterations on the card vs {c.iterations} on the CPU")
        dx = float((g.x.cpu() - c.x).abs().max() / c.x.abs().max())
        _require(dx <= FP64_TRUE_REL, f"{tag}: card vs CPU solution differs by {dx:.3e}")
        print(f"{tag}: levels {_describe(h_cpu)}; card {g.iterations} its, CPU {c.iterations} its, "
              f"max rel diff {dx:.3e}; card launches {counts}")
        if label == "Galerkin Poisson 64^3":
            out = h_dev
    return out


def _carve(x):
    """``x`` copied into a buffer of NaNs, NaNs planted at its first and
    last grid points: a read outside the grid, or of a neighbour a leg must
    skip, leaks a NaN where the twin has none."""
    pad = 4096
    buf = torch.full((x.numel() + 2 * pad,), float("nan"), dtype=x.dtype, device=x.device)
    xc = buf[pad : pad + x.numel()].view(x.shape)
    xc.copy_(x)
    xc[(0,) * x.ndim] = float("nan")
    xc[tuple(g - 1 for g in x.shape)] = float("nan")
    return xc


def _wide_kernel_checks(cases, dev, errs):
    """The wide kernel #3, reached through ``spmv_stencil_cuda``'s route, in
    its three instantiations against its twin on NaN-carved x: equal NaN
    patterns, the rest within KERNEL_REL (KERNEL_REL64 in fp64)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for label, A32 in cases:
        _require(var_route(A32) == "wide", f"wide {label}: routed {var_route(A32)}")
        for legs in LEG_DTYPES:
            A = A32.astype(legs)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            x = _carve(torch.randn(A.grid, generator=gen, device=dev, dtype=vec))
            before = spmv_stencil_wide_cuda.launches
            y, ref = spmv_stencil_cuda(A, x), spmv_stencil_ref(A, x)
            torch.cuda.synchronize()
            tag = f"spmv_stencil_wide {label} {TAGS[legs]} legs"
            _require(spmv_stencil_wide_cuda.launches == before + 1, f"{tag}: not the wide kernel")
            nan = torch.isnan(ref)
            _require(torch.equal(torch.isnan(y), nan) and 0 < int(nan.sum()) < nan.numel(),
                     f"{tag}: NaN pattern differs from the twin's (or is all or nothing)")
            err, scale = _max_err(y[~nan], ref[~nan])
            _require(err <= rel * scale, f"{tag}: max err {err:.3e} > {rel}*{scale:.3e}")
            errs["spmv_stencil_wide"] = max(errs["spmv_stencil_wide"], err)
            print(f"{tag}: max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}); NaN-carved x: "
                  f"{int(nan.sum())} NaN entries, the twin's")
            del A, x, y, ref


def _stencil_csr(A):
    """A device ``StencilMatrix`` as a CSR tensor (its legs as diagonals at
    the folded flat offsets; a leg is 0 where its neighbour leaves the
    grid, so the product is the same), fp64 legs in fp64, others upcast to
    fp32."""
    strides = [int(np.prod(A.grid[ax + 1:])) for ax in range(A.ndim)]
    offs = tuple(sum(s * st for s, st in zip(sh, strides)) for sh in A.shifts)
    vals = A.data.reshape(A.nlegs, -1)
    vals = vals if vals.dtype == torch.float64 else vals.float()
    return _csr(DiaMatrix(vals, offs, (A.n, A.n)))


def _wide_times(cases, dev, card, times, lib, bounds):
    """The wide kernel #3 at the paths' shapes (below 2e7 leg entries from a
    CUDA graph), each line with the split of the legs its launch takes,
    against its twin, its bound (each leg entry whose neighbour lies in the
    grid read once, x read once, y written once) and cuSPARSE's CSR product
    of the same operator (bf16 legs upcast to fp32, fp64 in fp64); the
    first case's fp32 row is the record's main shape."""
    for i, (label, A32, dtypes) in enumerate(cases):
        for legs in dtypes:
            A = A32.astype(legs)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            x = torch.randn(A.grid, device=dev, dtype=vec)
            n = x.numel()
            big = n * A.nlegs > 2e7
            call = lambda: spmv_stencil_wide_cuda(A, x)
            # below 2e7 leg entries the host launches slower than the card
            # runs the kernel: its device time from a CUDA graph's replay,
            # beside the time as launched from Python
            k_ms = (time_ms if big else graph_ms)(call, 50 if big else 200)
            launched = "" if big else f" (graph; {time_ms(call, 200):.4f} as launched)"
            p_ms = time_ms(lambda: spmv_stencil_ref(A, x), 3 if big else 20)
            nbytes = A.nnz * A.data.element_size() + 2 * n * x.element_size()
            all_legs = A.data.numel() * A.data.element_size() + 2 * n * x.element_size()
            bound = bound_ms(nbytes, 2 * A.nnz)
            csr = _stencil_csr(A)
            lib_ms = _library(f"spmv_stencil_wide {label} {TAGS[legs]} legs",
                              lambda: csr @ x.reshape(-1), spmv_stencil_wide_cuda(A, x).reshape(-1),
                              card, 50 if big else 200)
            del csr
            split = wide_geometry(wide_view(tuple(A.grid), tuple(A.shifts)), A.nlegs,
                                  cuda_stencil._sms(dev.index)).split
            times[("spmv_stencil_wide", label, TAGS[legs])] = (k_ms, p_ms, lib_ms)
            print(f"time spmv_stencil_wide {label} {TAGS[legs]} legs, split {split}: kernel "
                  f"{k_ms:.4f} ms{launched} "
                  f"({all_legs / 1e6 / k_ms:.0f} GB/s of {all_legs / 1e6:.1f} MB with every leg "
                  f"entry; bound {bound[0]:.4f} ms by {bound[1]} on {nbytes / 1e6:.1f} MB, "
                  f"{bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms, library call "
                  f"{lib_ms:.4f} ms [{card}]")
            if i == 0 and legs == torch.float32:
                lib["spmv_stencil_wide"], bounds["spmv_stencil_wide"] = lib_ms, bound
            del A, x


def _fmg_then_mgcg(s, grid, h, dev, card, from_zero):
    """One ``fmg`` pass over ``h`` (fp32), then MGCG from its result:
    converged, true fp64 relative residual within TRUE_REL, no more
    iterations than MGCG from zero.  Returns the launch counts of both."""
    tag = f"fmg + MGCG Poisson {grid} rediscretized"
    b = torch.from_numpy(s.b).to(dev, torch.float32)
    _reset_counts()
    t0 = time.perf_counter()
    x0 = fmg(h, b)
    torch.cuda.synchronize()
    fmg_ms = (time.perf_counter() - t0) * 1e3
    _require(tuple(x0.shape) == (s.n,) and bool(torch.isfinite(x0).all()), f"{tag}: bad fmg x")
    rel0 = _host_rel_residual(s.A, s.b, x0.cpu().numpy())
    res = api.solve(s.A, s.b, x0=x0, method="mgcg", grid=grid, tol=TOL, norm="rel_l2",
                    dtype=np.float32, device=dev, hierarchy=h, precise_dot=True)
    torch.cuda.synchronize()
    counts = _kind_counts()
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    rel = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    _require(res.iterations <= from_zero.iterations,
             f"{tag}: {res.iterations} iterations from fmg, {from_zero.iterations} from zero")
    print(f"{tag}: fmg true fp64 rel residual {rel0:.3e}; MGCG from it {res.iterations} iterations "
          f"(from zero {from_zero.iterations}), true fp64 rel residual {rel:.3e}; launches {counts}")
    print(f"time {tag}: fmg pass {fmg_ms:.3f} ms [{card}]")
    return counts


def _multigrid_kinds(dev, card, errs, count):
    """The rest of the multigrid build at full size, each path counted
    (``count``), the wide kernel #3 checked against its twin at the paths'
    shapes first.  Returns the wide kernel's timing cases."""
    h64 = _kind_small_card_vs_cpu(dev)
    s3 = _kind_system("poisson", KIND_GRID_3D)
    h3g = _kind_hierarchy(f"Galerkin Poisson {KIND_GRID_3D}", s3, KIND_GRID_3D, dev)
    s2 = _kind_system("poisson", KIND_GRID_2D)
    h2g = _kind_hierarchy(f"Galerkin Poisson {KIND_GRID_2D}", s2, KIND_GRID_2D, dev)
    st = _kind_system("tridiagonal", (KIND_TRIDIAG,))
    ht64 = _kind_hierarchy(f"tridiagonal {KIND_TRIDIAG} fp64", st, (KIND_TRIDIAG,), dev, dtype=None)
    w125 = next(l.A for l in h64.levels if isinstance(l.A, StencilMatrix) and l.A.nlegs == 125)
    wide = [("128^3 81 legs", h3g.levels[1].A), ("64^3 125 legs", h3g.levels[2].A),
            ("512^2 21 legs", h2g.levels[1].A),
            (f"1-D {ht64.levels[1].grid[0]} 5 legs", ht64.levels[1].A),
            ("16^3 125 legs (64^3 hierarchy)", w125)]
    wide += [(f"{l.grid[0]}^3 {l.A.nlegs} legs halo {max(l.A.halo)}", l.A) for l in h3g.levels[2:]
             if isinstance(l.A, StencilMatrix) and max(l.A.halo) > 2]
    for label, A in wide:
        _require(A.nlegs == int(label.split(" legs")[0].split()[-1])
                 and 2 <= max(A.halo) <= cuda_stencil.WIDE_HALO,
                 f"wide case {label}: {A.nlegs} legs, halo {A.halo}")
    _wide_kernel_checks([(label, A.astype(torch.float32)) for label, A in wide], dev, errs)

    res = {}
    for label, s, grid, h, kw in (
            (f"MGCG Galerkin Poisson {KIND_GRID_3D}", s3, KIND_GRID_3D, h3g, {}),
            (f"MGCG Galerkin Poisson {KIND_GRID_2D}", s2, KIND_GRID_2D, h2g, {})):
        counts, res[label] = _kind_mgcg(label, s, grid, h, dev, card, **kw)
        count(label, counts)
    h3r = _kind_hierarchy(f"rediscretized Poisson {KIND_GRID_3D}", s3, KIND_GRID_3D, dev,
                          coarse_operator=generators.poisson_coarse_operator(np.float32))
    _require(all(isinstance(l.A, ConstStencilMatrix) for l in h3r.levels),
             f"rediscretized {KIND_GRID_3D}: a level is not const")
    label = f"MGCG rediscretized Poisson {KIND_GRID_3D}"
    counts, v_res = _kind_mgcg(label, s3, KIND_GRID_3D, h3r, dev, card)
    count(label, counts)
    label = f"W-cycle MGCG rediscretized Poisson {KIND_GRID_3D}"
    counts, w_res = _kind_mgcg(label, s3, KIND_GRID_3D, h3r, dev, card, profile=False, gamma=2)
    count(label, counts)
    print(f"W-cycle against V-cycle, rediscretized {KIND_GRID_3D}: {w_res.iterations} against "
          f"{v_res.iterations} iterations")
    count(f"fmg + MGCG rediscretized Poisson {KIND_GRID_3D}",
          _fmg_then_mgcg(s3, KIND_GRID_3D, h3r, dev, card, v_res))
    del h3r
    for label, kw in (("layout dia", dict(layout="dia")), ("rbgs", dict(smoother="rbgs"))):
        h = _kind_hierarchy(f"Galerkin Poisson {KIND_GRID_2D} {label}", s2, KIND_GRID_2D, dev, **kw)
        path = f"MGCG Galerkin Poisson {KIND_GRID_2D} {label}"
        counts, _ = _kind_mgcg(path, s2, KIND_GRID_2D, h, dev, card)
        count(path, counts)
        del h
    sa = _kind_system("aniso", KIND_GRID_2D)
    ha = _kind_hierarchy(f"anisotropic {KIND_GRID_2D} ratios {KIND_RATIOS}", sa, KIND_GRID_2D, dev)
    _require(ha.levels[0].transfer.startswith("semi"), f"anisotropic: {ha.levels[0].transfer}")
    label = f"MGCG anisotropic {KIND_GRID_2D}"
    counts, _ = _kind_mgcg(label, sa, KIND_GRID_2D, ha, dev, card)
    count(label, counts)
    del ha
    ht32 = _kind_hierarchy(f"tridiagonal {KIND_TRIDIAG} fp32", st, (KIND_TRIDIAG,), dev)
    _require(ht32.levels[0].transfer == "agg", f"tridiagonal: {ht32.levels[0].transfer}")
    label = f"MGCG tridiagonal {KIND_TRIDIAG} (simple_cuda)"
    counts, _ = _kind_mgcg(label, st, (KIND_TRIDIAG,), ht32, dev, card)
    count(label, counts)
    label = f"default-dtype MGCG tridiagonal {KIND_TRIDIAG} (simple_cuda)"
    counts, _ = _kind_mgcg(label, st, (KIND_TRIDIAG,), ht64, dev, card, dtype=None)
    count(label, counts, fp32=False)
    return [(label, A.astype(torch.float32),
             (torch.float32, torch.bfloat16, torch.float64) if i == 0 else (torch.float32,))
            for i, (label, A) in enumerate(wide)]


def _nan_buffered(X):
    """``X`` copied into the middle of a NaN-filled buffer, no NaN inside: a
    read past [0, n) leaks a NaN where the twin has none."""
    pad = 8192
    buf = torch.full((X.numel() + 2 * pad,), float("nan"), dtype=X.dtype, device=X.device)
    Xc = buf[pad : pad + X.numel()].view(X.shape)
    Xc.copy_(X)
    return Xc


def _many_diag_checks(cases, dev, errs):
    """Kernels #4 (plain and fused) and #5 at k = MANY_K against their twins
    past 256 diagonals, fp32 and fp64, on NaN-buffered vectors; each call
    must launch once per group of ``dia_groups`` (and column chunk)."""
    rng = np.random.default_rng(SEED + 3)
    for label, A_host in cases:
        groups = len(dia_groups(A_host.ndiags))
        for legs in (torch.float32, torch.float64):
            A = A_host.device_put(legs, dev)
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            tag = f"{label} {TAGS[legs]}"
            x = _nan_buffered(torch.from_numpy(rng.standard_normal(A.n)).to(dev, legs))
            X = _nan_buffered(torch.from_numpy(rng.standard_normal((MANY_K, A.n))).to(dev, legs))
            _reset_counts()
            y = spmv_dia_cuda(A, x)
            yf, dot = spmv_dot_dia_cuda(A, x)
            Y = spmm_dia_cuda(A, X)
            torch.cuda.synchronize()
            launches = (spmv_dia_cuda.launches, spmv_dot_dia_cuda.launches, spmm_dia_cuda.launches)
            want = (groups, groups, groups * len(cuda_dia.spmm_chunks(A, MANY_K)))
            _require(launches == want, f"{tag}: launches {launches}, want {want} ({groups} groups)")
            ref, Yr = spmv_dia_ref(A, x), spmm_dia_ref(A, X)
            err, scale = _max_err(y, ref)
            errY, scaleY = _max_err(Y, Yr)
            dot_err = abs(float(dot) - float(torch.dot(x, ref)))
            dot_scale = float((x * ref).abs().sum())
            _require(err <= rel * scale, f"spmv_dia {tag}: max err {err:.3e} > {rel}*{scale:.3e}")
            _require(torch.equal(yf, y), f"spmv_dot_dia {tag}: fused A p differs from the SpMV's")
            _require(dot_err <= rel * dot_scale, f"spmv_dot_dia {tag}: p.Ap err {dot_err:.3e}")
            _require(errY <= rel * scaleY, f"spmm_dia {tag} k={MANY_K}: max err {errY:.3e}")
            errs["spmv_dia"] = max(errs["spmv_dia"], err)
            if legs != torch.float64:
                errs["spmm_dia"] = max(errs["spmm_dia"], errY)
            print(f"spmv_dia / spmm_dia {tag} ({A.ndiags} diagonals in {groups} chained groups): "
                  f"max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}), fused p.Ap err "
                  f"{dot_err:.3e}, k={MANY_K} {errY:.3e}; launches {launches}")


def _dia_layout_mgcg(wide_cases, dev, card, errs, count):
    """The repair's path.  The DIA-layout Galerkin hierarchy of Poisson
    DIA_MGCG_GRID in fp32 (levels of 7, 81, 125 and 343 diagonals); kernels
    #4 and #5 against their twins on its 343-diagonal level and on the 256^3
    hierarchy's 16^3 level as DIA (1331 diagonals); then
    ``api.solve(method="mgcg", layout="dia")``, counted: #4 at every level,
    the 343-diagonal one in chained groups, beside the stencil-layout
    solve's iteration count.  Returns the (label, host DIA) cases."""
    g = DIA_MGCG_GRID
    s = _kind_system("poisson", g)
    h = _kind_hierarchy(f"Galerkin Poisson {g} layout dia", s, g, dev, layout="dia")
    many = [lvl.A for lvl in h.levels if lvl.A.ndiags > cuda_dia.MAX_DIAGS]
    _require([A.ndiags for A in many] == [DIA_MGCG_MANY], f"{g} layout dia: levels {_describe(h)}")
    w1331 = next(A for label, A, _ in wide_cases if A.nlegs == 1331)
    cases = [(f"{g[0]}^3 hierarchy's 16^3 level", to_host(many[0])),
             (f"{KIND_GRID_3D[0]}^3 hierarchy's 16^3 level as DIA", stencil_to_dia(to_host(w1331)))]
    _many_diag_checks(cases, dev, errs)
    kw = dict(method="mgcg", grid=g, tol=TOL, norm="rel_l2", dtype=np.float32, device=dev,
              precise_dot=True)
    tag = f"MGCG Galerkin Poisson {g} layout dia"
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(s.A, s.b, hierarchy=h, layout="dia", **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, by_shape = spmv_dia_cuda.launches, dict(spmv_dia_cuda.launches_by_shape)
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    rel = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    _levels_launched(tag, h)
    n_many = by_shape.get((many[0].n, DIA_MGCG_MANY), 0)
    _require(n_many > 0 and n_many % len(dia_groups(DIA_MGCG_MANY)) == 0,
             f"{tag}: {n_many} launches on the {DIA_MGCG_MANY}-diagonal level, not whole chains")
    count(tag, {"spmv_dia": launches})
    del h
    hs = _kind_hierarchy(f"Galerkin Poisson {g}", s, g, dev)
    _reset_counts()
    res_s = api.solve(s.A, s.b, hierarchy=hs, **kw)
    torch.cuda.synchronize()
    _require(res_s.converged, f"MGCG Galerkin Poisson {g}: did not converge")
    count(f"MGCG Galerkin Poisson {g}", _kind_counts())
    print(f"{tag}: {res.iterations} iterations (stencil layout {res_s.iterations}), rel_l2 "
          f"{float(res.residual):.3e}, true fp64 rel residual {rel:.3e}; spmv_dia launches "
          f"{launches} by (rows, diagonals) { {str(k): v for k, v in sorted(by_shape.items())} }")
    print(f"time {tag} api.solve (counted run): {wall * 1e3:.3f} ms [{card}]")
    return cases


def _true_l2(A, b, x):
    """||b - A x||_2 in fp64 by the host oracle."""
    return float(np.linalg.norm(b - oracle.spmv(A, np.asarray(x, dtype=np.float64))))


def _textbook_cg_true_l2(csr, fsys, iterations):
    """The witness of plain fp64 CG's attainable accuracy that is not the
    port's: scipy's textbook CG on the host CSR from the same x0 for the
    same number of iterations; its true ``||b - A x||_2``.  The CPU tests
    hold scipy's CG to the JAX package's on the flagship's generator at
    4096 rows (within 2x; 0.1% apart there)."""
    import scipy.sparse.linalg as sla

    A = to_scipy(csr)
    try:
        x, _ = sla.cg(A, fsys.b, x0=fsys.x0, rtol=0.0, atol=0.0, maxiter=iterations)
    except TypeError:  # scipy < 1.12 names rtol tol
        x, _ = sla.cg(A, fsys.b, x0=fsys.x0, tol=0.0, atol=0.0, maxiter=iterations)
    return _true_l2(fsys.A, fsys.b, x)


def _eval_floor(A, b, x):
    """eps64 * || |A| |x| + |b| ||_2: the rounding of one fp64 evaluation of
    b - A x at x, below which no residual can be told from 0."""
    absA = DiaMatrix(np.abs(A.data), A.offsets, A.shape)
    x = np.abs(np.asarray(x, dtype=np.float64))
    return float(np.finfo(np.float64).eps * np.linalg.norm(oracle.spmv(absA, x) + np.abs(b)))


def _kernel_route(tag, A_ell_or_csr, b, x0, policy, dev, count):
    """``make_kernel_operator`` (the relayout to DIA, timed) into
    ``cg_solve``, counted: kernel #4 once per iteration and once for the
    initial residual.  Returns the result."""
    t0 = time.perf_counter()
    op = make_kernel_operator(A_ell_or_csr, device=dev)
    relayout = time.perf_counter() - t0
    _reset_counts()
    t0 = time.perf_counter()
    res = cg_solve(op, torch.from_numpy(b).to(dev), torch.from_numpy(x0).to(dev), policy)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmv_dia_cuda.launches
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    _require(launches == res.iterations + 1,
             f"{tag}: {launches} spmv_dia launches, not iterations + 1 = {res.iterations + 1}")
    count(tag, {"spmv_dia": launches}, fp32=False)
    print(f"{tag}: relayout {relayout:.3f} s, {res.iterations} iterations, spmv_dia launches "
          f"{launches}, wall {wall * 1e3:.3f} ms")
    return res


def _reference_storage(fsys, dev, card, count):
    """The reference's own storage, fp64 with each workload's policy.  The
    flagship as CSR (``dia_to_csr``): ``api.solve(method="cg")`` (no
    kernel: cuSPARSE's CSR product) and ``make_kernel_operator`` into
    ``cg_solve`` (kernel #4), both converged under the workload's policy
    with a true ``||b - A x||_2`` below FLAGSHIP_CG_TRUE and within
    CG_ORDER_SPREAD of scipy's textbook CG's,
    the CSR solve run twice (bit-identity printed), then an n x 4 block
    whose column 0 takes the single solve's count.  The HandmadeCL workload
    as diagonal-first ELL (``csr_to_ell``) both ways.  Returns the flagship
    CSR."""
    pol = WORKLOADS[FLAGSHIP].policy
    kw = dict(method="cg", tol=pol.tol, norm=pol.norm, min_iteration=pol.min_iteration,
              max_iteration=pol.max_iteration, device=dev)
    t0 = time.perf_counter()
    csr = dia_to_csr(fsys.A)
    conv = time.perf_counter() - t0
    tag = f"flagship CSR ({csr.nnz} nnz)"
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(csr, fsys.b, fsys.x0, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(spmv_dia_cuda.launches == 0, f"{tag}: api.solve launched kernel #4")
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    r_true = _true_l2(fsys.A, fsys.b, res.x.cpu().numpy())
    _require(r_true < FLAGSHIP_CG_TRUE, f"{tag}: true fp64 ||b - A x||_2 {r_true:.3e}")
    again = api.solve(csr, fsys.b, fsys.x0, **kw)
    same = bool(torch.equal(again.x, res.x)) and again.iterations == res.iterations
    print(f"{tag}: dia_to_csr {conv:.3f} s; api.solve(method='cg') {res.iterations} iterations, "
          f"true fp64 ||r||_2 {r_true:.3e}, 0 spmv_dia launches, wall {wall * 1e3:.3f} ms; run "
          f"twice: x bit-identical {same} (max |diff| "
          f"{float((again.x - res.x).abs().max()):.3e}) [{card}]")
    res_k = _kernel_route(f"{tag} via make_kernel_operator", csr, fsys.b, fsys.x0, pol, dev, count)
    r_k = _true_l2(fsys.A, fsys.b, res_k.x.cpu().numpy())
    _require(r_k < FLAGSHIP_CG_TRUE, f"{tag} via make_kernel_operator: true ||r||_2 {r_k:.3e}")
    t0 = time.perf_counter()
    r_w = _textbook_cg_true_l2(csr, fsys, res.iterations)
    floor = _eval_floor(fsys.A, fsys.b, res.x.cpu().numpy())
    _require(max(r_true, r_k) <= CG_ORDER_SPREAD * r_w,
             f"{tag}: true ||r||_2 {r_true:.3e} (CSR) / {r_k:.3e} (#4) over {CG_ORDER_SPREAD}x "
             f"scipy's textbook CG's {r_w:.3e}")
    print(f"{tag} via make_kernel_operator: true fp64 ||r||_2 {r_k:.3e}; scipy's textbook CG, "
          f"{res.iterations} iterations on the host: {r_w:.3e} ({time.perf_counter() - t0:.1f} s); "
          f"against it: CSR {r_true / r_w:.3f}x, kernel #4 {r_k / r_w:.3f}x; evaluation floor "
          f"eps |A||x| {floor:.3e} (CSR {r_true / floor:.0f}x, #4 {r_k / floor:.0f}x)")
    rng = np.random.default_rng(SEED + 4)
    B = np.column_stack([fsys.b] + [rng.standard_normal(fsys.n) for _ in range(FORMAT_K - 1)])
    X0 = np.column_stack([fsys.x0] * FORMAT_K)
    resB = api.solve(csr, B, X0, **kw)
    its = resB.iterations.cpu().tolist()
    _require(bool(resB.converged.all()), f"{tag} n x {FORMAT_K}: converged {resB.converged}")
    _require(its[0] == res.iterations, f"{tag} n x {FORMAT_K}: column 0 took {its[0]} iterations, "
                                       f"the single solve {res.iterations}")
    print(f"{tag} n x {FORMAT_K} api.solve(method='cg'): iterations by column {its}")

    hw = WORKLOADS[HANDMADE]
    hsys = hw.build(dtype=np.float64)
    t0 = time.perf_counter()
    ell = csr_to_ell(dia_to_csr(hsys.A))
    conv = time.perf_counter() - t0
    _require(np.array_equal(ell.cols[:, 0], np.arange(hsys.n)), "HandmadeCL ELL: diagonal not first")
    tag = f"HandmadeCL ELL (n {hsys.n}, k {ell.k})"
    hkw = dict(method="cg", tol=hw.policy.tol, norm=hw.policy.norm,
               min_iteration=hw.policy.min_iteration, max_iteration=hw.policy.max_iteration, device=dev)
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(ell, hsys.b, hsys.x0, **hkw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _require(spmv_dia_cuda.launches == 0, f"{tag}: api.solve launched kernel #4")
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    linf = float(np.abs(hsys.b - oracle.spmv(hsys.A, res.x.cpu().numpy())).max())
    _require(linf < hw.policy.tol, f"{tag}: true max|b - A x| {linf:.3e}")
    res_k = _kernel_route(f"{tag} via make_kernel_operator", ell, hsys.b, hsys.x0, hw.policy, dev,
                          count)
    linf_k = float(np.abs(hsys.b - oracle.spmv(hsys.A, res_k.x.cpu().numpy())).max())
    _require(linf_k < hw.policy.tol, f"{tag} via make_kernel_operator: true max|r| {linf_k:.3e}")
    print(f"{tag}: csr_to_ell(dia_to_csr) {conv:.3f} s; api.solve {res.iterations} iterations, "
          f"true max|r| {linf:.3e}, wall {wall * 1e3:.3f} ms; via make_kernel_operator "
          f"{res_k.iterations} iterations, true max|r| {linf_k:.3e} [{card}]")
    return csr


def _ingestion(dev, card, count):
    """Poisson MTX_GRID fp32 through Matrix Market files: permuted by a
    seeded symmetric permutation it must load as CSR (the blowup guard sees
    ~2 M diagonals) and solve with 0 kernel #4 launches; unpermuted it must
    load as DIA and solve on kernel #4, then as an n x 4 block on #5.  Each
    solve ``rel_l2 < TOL``, true fp64 relative residual within TRUE_REL."""
    g = MTX_GRID
    s = generators.poisson_system(g, dtype=np.float32)
    perm = np.random.default_rng(SEED).permutation(s.n)
    t0 = time.perf_counter()
    permuted = from_scipy(to_scipy(s.A)[perm][:, perm])
    perm_s = time.perf_counter() - t0
    kw = dict(method="cg", tol=TOL, norm="rel_l2", dtype=np.float32, device=dev, precise_dot=True)
    with tempfile.TemporaryDirectory() as d:
        for label, A_file, b, kind in (("permuted", permuted, s.b[perm], CsrMatrix),
                                       ("unpermuted", s.A, s.b, DiaMatrix)):
            path = os.path.join(d, f"poisson_{label}.mtx")
            t0 = time.perf_counter()
            save_matrix_market(path, A_file)
            w_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            A = load_matrix_market(path)
            r_s = time.perf_counter() - t0
            tag = f"Poisson {g} .mtx {label}"
            _require(isinstance(A, kind), f"{tag}: loaded as {type(A).__name__}, not {kind.__name__}")
            _reset_counts()
            t0 = time.perf_counter()
            res = api.solve(A, b, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = spmv_dia_cuda.launches
            _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
            rel = _host_rel_residual(A, b, res.x.cpu().numpy())
            _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
            want = 0 if kind is CsrMatrix else res.iterations + 1
            _require(launches == want, f"{tag}: {launches} spmv_dia launches, want {want}")
            size = f"{A.ndiags} diagonals" if kind is DiaMatrix else f"{A.nnz} nnz"
            print(f"{tag}: {os.path.getsize(path) / 1e6:.1f} MB, write {w_s:.3f} s, read "
                  f"{r_s:.3f} s ({type(A).__name__}, {size}); "
                  f"api.solve(method='cg') {res.iterations} iterations, true fp64 rel residual "
                  f"{rel:.3e}, spmv_dia launches {launches}, wall {wall * 1e3:.3f} ms [{card}]")
            if kind is DiaMatrix:
                count(f"{tag} api.solve(method='cg')", {"spmv_dia": launches})
                rng = np.random.default_rng(SEED + 5)
                B = np.column_stack([b] + [rng.standard_normal(s.n) for _ in range(FORMAT_K - 1)])
                _reset_counts()
                resB = api.solve(A, B, **{k: v for k, v in kw.items() if k != "precise_dot"})
                torch.cuda.synchronize()
                its = resB.iterations.cpu().tolist()
                _require(bool(resB.converged.all()) and spmm_dia_cuda.launches > 0,
                         f"{tag} n x {FORMAT_K}: converged {resB.converged}, "
                         f"{spmm_dia_cuda.launches} spmm_dia launches")
                count(f"{tag} api.solve(B n x {FORMAT_K}, method='cg')",
                      {"spmm_dia": spmm_dia_cuda.launches})
                print(f"{tag} n x {FORMAT_K}: iterations by column {its}, spmm_dia launches "
                      f"{spmm_dia_cuda.launches}")
    print(f"Poisson {g}: symmetric permutation of the matrix {perm_s:.3f} s")


def _many_diag_times(cases, dev, card):
    """Kernels #4 and #5 (k = MANY_K) past 256 diagonals, fp32 and fp64:
    kernel (as launched and from a CUDA graph), twin and cuSPARSE's CSR
    product beside the bound (the legs inside the matrix, x and y once)."""
    rng = np.random.default_rng(SEED + 6)
    for label, A_host in cases:
        for legs in (torch.float32, torch.float64):
            A = A_host.device_put(legs, dev)
            n, nnz, size = A.n, dia_nnz(A), A.data.element_size()
            x = torch.from_numpy(rng.standard_normal(n)).to(dev, legs)
            X = torch.from_numpy(rng.standard_normal((MANY_K, n))).to(dev, legs)
            csr = _csr(A)
            tag = f"{label} {A.ndiags} diagonals {TAGS[legs]}"
            for op, k, fn, twin, lib in (
                    ("spmv_dia", 1, lambda: spmv_dia_cuda(A, x), lambda: spmv_dia_ref(A, x),
                     lambda: csr @ x),
                    ("spmm_dia", MANY_K, lambda: spmm_dia_cuda(A, X), lambda: spmm_dia_ref(A, X),
                     lambda: (csr @ X.T.contiguous()).T)):
                k_ms, g_ms, p_ms = time_ms(fn, 200), graph_ms(fn, 200), time_ms(twin, 5)
                lib_ms = _library(f"{op} {tag}", lib, fn(), card, 100)
                nbytes = nnz * size + 2 * k * n * size
                bound = bound_ms(nbytes, 2 * k * nnz)
                print(f"time {op} {tag} k={k}: kernel {k_ms:.4f} ms (graph {g_ms:.4f}; "
                      f"{nbytes / 1e6:.1f} MB, bound {bound[0]:.4f} ms by {bound[1]}, "
                      f"{bound[0] / g_ms:.1%} of it from the graph), {len(dia_groups(A.ndiags))} "
                      f"launches a call, twin {p_ms:.4f} ms, CSR {lib_ms:.4f} ms [{card}]")


def _format_bytes(A, k, size):
    """Bytes one product of a device CSR, ELL, BSR or dense matrix with k
    columns must move (``size`` bytes a value): its stored values and
    indices read once, x read and y written once."""
    n, m = A.shape
    vec = (n + m) * k * size
    if isinstance(A, CsrMatrix):
        return A.nnz * (size + 4) + (n + 1) * 4 + vec
    name = type(A).__name__
    if name == "EllMatrix":
        return A.data.numel() * (size + 4) + vec
    if name == "BsrMatrix":
        return A.data.numel() * size + A.nblocks * 4 + (n // A.block_shape[0] + 1) * 4 + vec
    return n * m * size + vec


def _format_products(csr, dev, card):
    """Every plain format's SpMV and SpMM (k = FORMAT_K) on the card in fp64
    against the fp64 oracle, each timed (the solvers' operator: a COO
    matrix sorted into its CSR once) beside its bound: the flagship as CSR,
    ELL and COO, Poisson DIA_MGCG_GRID as BSR_BLOCK blocks, banded_sin at
    DENSE_N rows as dense; and the flagship's CSR through kernel #4
    (``make_kernel_operator``).  No format here is a TPU kernel: the JAX
    package runs them by XLA."""
    bsr = csr_to_bsr(dia_to_csr(generators.poisson_system(DIA_MGCG_GRID).A), BSR_BLOCK)
    cases = [("CSR flagship", csr), ("ELL flagship", csr_to_ell(csr)),
             ("COO flagship", csr_to_coo(csr)), (f"BSR {BSR_BLOCK} Poisson {DIA_MGCG_GRID}", bsr),
             (f"dense banded_sin n={DENSE_N}", dia_to_dense(generators.banded_sin_matrix(DENSE_N, 160)))]
    rng = np.random.default_rng(SEED + 7)
    for label, A_host in cases:
        # the container the solvers run: a COO matrix as its row-sorted CSR
        # (the bytes are the CSR's)
        A_mm = prepare(A_host, dev)
        x_h, X_h = rng.standard_normal(A_mm.n), rng.standard_normal((A_mm.n, FORMAT_K))
        x, X = torch.from_numpy(x_h).to(dev), torch.from_numpy(X_h).to(dev)
        op = as_operator(A_mm)
        y, Y = op(x), spmm(A_mm, X)
        ref = oracle.spmv(A_host, x_h)
        refY = np.column_stack([oracle.spmv(A_host, X_h[:, j]) for j in range(FORMAT_K)])
        e1 = float(np.abs(y.cpu().numpy() - ref).max() / np.abs(ref).max())
        eK = float(np.abs(Y.cpu().numpy() - refY).max() / np.abs(refY).max())
        _require(e1 <= FORMAT_REL64 and eK <= FORMAT_REL64,
                 f"format {label}: rel err {e1:.3e} / {eK:.3e} against the fp64 oracle")
        for k, fn in ((1, lambda: op(x)), (FORMAT_K, lambda: spmm(A_mm, X))):
            ms = time_ms(fn, 50)
            nbytes = _format_bytes(A_mm, k, 8)
            bound = bound_ms(nbytes, 2 * k * A_host.nnz if hasattr(A_host, "nnz") else 2 * k * A_mm.n ** 2)
            print(f"time format {label} fp64 k={k}: {ms:.4f} ms ({nbytes / 1e6:.1f} MB, bound "
                  f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / ms:.1%} of it); rel err against "
                  f"the oracle {e1 if k == 1 else eK:.3e} [{card}]")
    op = make_kernel_operator(csr, device=dev)
    x = torch.from_numpy(rng.standard_normal(csr.n)).to(dev)
    print(f"time format CSR flagship fp64 through kernel #4 (make_kernel_operator): "
          f"{time_ms(lambda: op(x), 200):.4f} ms [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs = {k: 0.0 for k in KERNELS}
    t_run = time.perf_counter()

    # -- phase 1: device ---------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    card = card_name()
    print(f"device: {kind} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(card)

    t0 = time.perf_counter()
    lib_paths = _build.build()
    for name in lib_paths:
        _build.load(name)
    print(f"build: {sorted(p.name for p in lib_paths.values())} in {time.perf_counter() - t0:.3f} s")
    for name in lib_paths:
        for entry, res in sorted(_build.kernel_resources(name).items()):
            print(f"  ptxas {name}: {entry[:72]} {res}")
    for src, kernel in (("stencil", "spmv_const_kernel"), ("stencil", "cheb_const_kernel"),
                        ("stencil_var", "spmv_var_kernel"), ("stencil_var", "spmv_var_wide_kernel"),
                        ("dia", "spmm_dia_kernel"),
                        ("dia", "spmm_dia_acc_kernel")):
        res = {e: r for e, r in _build.kernel_resources(src).items() if kernel in e}
        _require(bool(res), f"ptxas: no {kernel} entry in the {src} build log")
        bad = {e: r for e, r in res.items()
               if (r.get("stack"), r.get("spill_stores"), r.get("spill_loads")) != (0, 0, 0)}
        _require(not bad, f"ptxas: {kernel} instantiations with a stack frame or spills: {bad}")
        regs = [r["registers"] for r in res.values()]
        print(f"ptxas {kernel}: {len(res)} instantiations, all with a 0-byte stack frame and 0 "
              f"spill bytes, {min(regs)}-{max(regs)} registers")
    _acc_geometry(card)

    torch.manual_seed(SEED)  # the kernel-#3 checks and times draw from the default generator
    rng = torch.Generator(device=dev).manual_seed(SEED)
    rand = lambda g: torch.randn(g, generator=rng, device=dev, dtype=torch.float32)

    # -- phase 2: kernels vs twins on the card ------------------------------
    ops = {g: _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
           for g in TIME_SPMV_GRIDS}
    _const_kernel_checks(dev, errs)
    for g in CHEB_GRIDS + EVEN_GRIDS:
        A = ops.get(g) or _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
        ops[g] = A
        lo, hi = _const_bounds(A)
        invd = torch.tensor(1.0 / A.coeffs[A.shifts.index((0, 0, 0))], device=dev)
        _cheb_checks(f"{g}", A, lo, hi, invd, rand, errs)
    for g in CHEB_EDGE_GRIDS:
        A = _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
        lo, hi = _const_bounds(A)
        invd = torch.tensor(1.0 / A.coeffs[A.shifts.index((0, 0, 0))], device=dev)
        _cheb_checks(f"{g}", A, lo, hi, invd, rand, errs, CHEB_EDGE_DEGREES)
    rev = ConstStencilMatrix(A.coeffs[::-1], A.shifts[::-1], A.grid)
    _cheb_checks(f"{A.grid} legs reversed", rev, lo, hi, invd, rand, errs, CHEB_EDGE_DEGREES)
    _cheb_galerkin_checks(dev, rand, errs)

    # small solves on the card agree with the same solves on the CPU (twins)
    for g in SMALL_GRIDS:
        sys_ = generators.poisson_system(g, dtype=np.float32)
        _, b_gpu, solve_gpu, _ = _mgcg(sys_, g, dev)
        h_cpu, b_cpu, solve_cpu, _ = _mgcg(sys_, g, "cpu")
        r_gpu, r_cpu = solve_gpu(), solve_cpu()
        _check_solution(f"small MGCG {g}", h_cpu.levels[0].A, b_gpu, r_gpu)
        dx = float((r_gpu.x.cpu() - r_cpu.x).abs().max() / r_cpu.x.abs().max())
        _require(abs(r_gpu.iterations - r_cpu.iterations) <= 1,
                 f"small MGCG {g}: {r_gpu.iterations} iterations on the card vs {r_cpu.iterations} on the CPU")
        _require(dx <= SMALL_AGREE, f"small MGCG {g}: card vs CPU solution differs by {dx:.3e}")
        print(f"small MGCG {g}: card {r_gpu.iterations} its, CPU {r_cpu.iterations} its, "
              f"max rel diff {dx:.3e}")
    torch.cuda.synchronize()

    # DIA kernels (#4 in three instantiations and fused, #5) vs their twins
    t0 = time.perf_counter()
    fsys = WORKLOADS[FLAGSHIP].build(dtype=np.float64)
    print(f"flagship system {FLAGSHIP}: n {fsys.n}, {fsys.A.ndiags} diagonals, "
          f"built in {time.perf_counter() - t0:.3f} s")
    _dia_kernel_checks(_dia_cases(fsys.A), dev, errs)
    _acc_kernel_checks(dev, errs)
    _small_refine_card_vs_cpu(dev)

    # kernel #3 (three instantiations) vs its twin: small diffusion
    # operators, then the 255^3 jump fine level and its 127^3 27-leg level
    sysj, hj = _var_hierarchy("jump", dev)
    cases = []
    for label, g in VAR_CHECK_GRIDS:
        A_h = generators.diffusion_system(g, kind="jump", contrast=VAR_CONTRAST, seed=SEED).A
        cases.append((label, dia_to_stencil(A_h, g).device_put(torch.float32, dev)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, shifts, g in VAR_HAND:
        legs = torch.rand((len(shifts),) + g, generator=gen, device=dev) * 2 - 1
        cases.append((f"hand-made {label}", StencilMatrix(legs, shifts, g)))
    cases += [("3-D 255^3 7 legs (jump)", hj.levels[0].A),
              ("127^3 27-leg Galerkin level (jump)", hj.levels[1].A)]
    _var_kernel_checks(cases, dev, errs)
    del cases
    _spmm_jump_check(sysj, dev, errs)
    _small_var_mgcg_card_vs_cpu(dev)

    # -- phases 3-4: the main path, counted ---------------------------------
    sys2 = generators.poisson_system(GRID_2D, dtype=np.float32)
    sys3 = generators.poisson_system(GRID_3D, dtype=np.float32)
    h2, b2, solve2, setup2 = _mgcg(sys2, GRID_2D, dev)
    h3, b3, solve3, setup3 = _mgcg(sys3, GRID_3D, dev)
    torch.cuda.synchronize()
    cuda_stencil.reset_launch_counts()
    res2 = solve2()
    res3 = solve3()
    torch.cuda.synchronize()
    # launches[name]: kernel name's count on the fp32 paths (the record's
    # "launches"); by_path[name]: each path's own count, the default-dtype
    # (fp64) paths too (the record's "launches_by_path")
    launches = dict.fromkeys(KERNELS, 0)
    by_path = {name: {} for name in KERNELS}

    def count(path, counts, fp32=True):
        for name, n in counts.items():
            if n:
                by_path[name][path] = n
                if fp32:
                    launches[name] += n

    count("Poisson MGCG 1023^2 + 255^3", {"spmv_const_stencil": spmv_const_stencil_cuda.launches,
                                          "cheb_smooth_const": cheb_smooth_const_cuda.launches})
    by_grid = dict(cheb_smooth_const_cuda.launches_by_grid)
    const_by_grid = dict(spmv_const_stencil_cuda.launches_by_grid)

    rel2 = _check_solution("MGCG 2-D", h2.levels[0].A, b2, res2)
    rel3 = _check_solution("MGCG 3-D", h3.levels[0].A, b3, res3)
    print(f"MGCG 2-D {GRID_2D}: {res2.iterations} iterations, rel_l2 {float(res2.residual):.3e}, "
          f"true fp64 rel residual {rel2:.3e}, levels {[l.grid for l in h2.levels]} + "
          f"coarse {h2.coarse_inv.shape[0]}, setup {setup2:.2f} s")
    print(f"MGCG 3-D {GRID_3D}: {res3.iterations} iterations, rel_l2 {float(res3.residual):.3e}, "
          f"true fp64 rel residual {rel3:.3e}, levels {[l.grid for l in h3.levels]} + "
          f"coarse {h3.coarse_inv.shape[0]}, setup {setup3:.2f} s")

    # -- phase 5: path proof ------------------------------------------------
    for name in ("spmv_const_stencil", "cheb_smooth_const"):
        _require(launches[name] > 0, f"{name}: no launch on the main path")
    for lvl in h3.levels:
        _require(by_grid.get(lvl.grid, 0) > 0, f"cheb_smooth_const: no launch at 3-D level {lvl.grid}")
    for lvl in h2.levels:
        _require(const_by_grid.get(lvl.grid, 0) > 0, f"spmv_const_stencil: no launch at 2-D level {lvl.grid}")
    print(f"launches on the main path: {by_path}; fused Chebyshev by grid: "
          f"{ {str(k): v for k, v in sorted(by_grid.items(), reverse=True)} }; const-stencil SpMV "
          f"by grid: { {str(k): v for k, v in sorted(const_by_grid.items(), reverse=True)} }")

    # plain CG on the 2-D system, for comparison
    policy2 = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=8 * sys2.n)
    plain = lambda: cg_solve(h2.levels[0].A, b2, policy=policy2, precise_dot=True)
    res_plain = plain()
    rel_plain = _check_solution("plain CG 2-D", h2.levels[0].A, b2, res_plain)
    print(f"plain CG 2-D {GRID_2D}: {res_plain.iterations} iterations, "
          f"true fp64 rel residual {rel_plain:.3e}")

    # -- the flagship path, counted: three refined routes, then multi-RHS ----
    for route, counts in _flagship_routes(fsys, dev, card).items():
        count(f"flagship refined, {route}", {"spmv_dia": sum(counts.values())})
    count("flagship refined n x 4", {"spmm_dia": _flagship_multi(fsys, dev, card)})

    # -- the default dtype, counted: fp64 MGCG (kernel #1 in fp64, 3-D and
    # 1-D), a b on the card, and the fp64 flagship block CG (kernel #5) -----
    for path, n in _fp64_mgcg(dev, card).items():
        count(path, {"spmv_const_stencil": n}, fp32=False)
    count(f"fp64 flagship block CG n x {MULTI_K}", {"spmm_dia": _fp64_block_cg(fsys, dev, card)},
          fp32=False)

    # -- the variable-coefficient path, counted: jump MGCG, smooth refined ---
    walls = {}
    var_mgcg, single_jump, walls["MGCG jump 255^3 warm solve"] = _var_mgcg(sysj, hj, dev, card)
    count("MGCG jump 255^3", {"spmv_stencil": var_mgcg})
    syss, hs = _var_hierarchy("smooth", dev, SMOOTH_GRID)
    var_refine, single_smooth, _ = _var_refine_routes(syss, hs, dev, card)
    count("refined smooth 127^3 bf16 legs, host + device residual", {"spmv_stencil": var_refine})

    # -- the multi-RHS grid path, counted: 255^3 jump MGCG (reusing its
    # hierarchy), the 63^3 facade, the 255^3 smooth refined solve ------------
    multi_counts, walls["multi-RHS MGCG jump 255^3 k=4"] = _multi_mgcg(sysj, hj, single_jump, dev, card)
    count(f"multi-RHS MGCG jump 255^3 k={MULTI_K}", multi_counts)
    count(f"api.solve(B, mgcg) {FACADE_GRID} k={MULTI_K}", _facade_multi_mgcg(dev, card))
    count(f"refined_solve_multi smooth 127^3 k={REFINE_MULTI_K}",
          _refine_multi(syss, hs, single_smooth, dev, card))
    del syss, hs

    # -- kernel #6's path, counted: the experiment at its default shape ------
    acc_launches, acc_recs = _acc_experiment(sysj, dev)
    count("kernel #6 experiment", {"spmm_dia_acc": acc_launches})

    # -- the rest of the multigrid build, counted: hybrid, semicoarsening and
    # aggregation transfers (the wide kernel #3 checked first), DIA levels,
    # rbgs, W-cycle and fmg -------------------------------------------------
    wide_cases = _multigrid_kinds(dev, card, errs, count)

    # -- the formats slice, counted: kernels #4 and #5 past 256 diagonals and
    # the DIA-layout MGCG over them; the reference's CSR and ELL storage;
    # Matrix Market ingestion ------------------------------------------------
    t0 = time.perf_counter()
    many_cases = _dia_layout_mgcg(wide_cases, dev, card, errs, count)
    print(f"phase: past 256 diagonals and the {DIA_MGCG_GRID} DIA-layout MGCG in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flagship_csr = _reference_storage(fsys, dev, card, count)
    print(f"phase: the reference's CSR and ELL storage in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _ingestion(dev, card, count)
    print(f"phase: Matrix Market ingestion in {time.perf_counter() - t0:.1f} s")

    # -- phase 6: times -----------------------------------------------------
    times = {}
    for g in TIME_SPMV_GRIDS:  # Poisson; below 2 M points from a CUDA graph
        A = ops[g]
        x = rand(g)
        small = np.prod(g) < 2e6
        reps = 200 if small else 50
        k_ms = (graph_ms if small else time_ms)(lambda: spmv_const_stencil_cuda(A, x), reps)
        p_ms = time_ms(lambda: spmv_const_stencil_ref(A, x), reps)
        times[("spmv_const_stencil", g)] = (k_ms, p_ms)
        print(f"time spmv_const_stencil Poisson {g}{' (graph)' if small else ''}: kernel "
              f"{k_ms:.4f} ms, twin {p_ms:.4f} ms [{card}]")
    _const_times(dev, card)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for g in TIME_CHEB_GRIDS:
        A = ops.get(g) or _const_poisson(generators.poisson_system(g, dtype=np.float32).A, g)
        lo, hi = _const_bounds(A)
        invd = torch.tensor(1.0 / A.coeffs[A.shifts.index((0, 0, 0))], device=dev)
        b, x0 = rand(g), rand(g)
        n = int(np.prod(g))
        reps = 200 if n < 1e6 else 20
        for label, zero_x, want_resid in CHEB_VARIANTS:
            args = (A, b, None if zero_x else x0, 2, hi, lo, invd, want_resid)
            k_ms = time_ms(lambda: cheb_smooth_const_cuda(*args), reps)
            p_ms = time_ms(lambda: cheb_smooth_const_ref(*args), reps)
            nbytes = _cheb_bytes(n, zero_x, want_resid)
            bound = bound_ms(nbytes, _cheb_flops(A.nlegs, 2, zero_x, want_resid) * n)
            chunk = cheb_geometry(2, zero_x, want_resid, g, sms).chunk
            times[("cheb_smooth_const", g, label)] = (k_ms, p_ms)
            print(f"time cheb_smooth_const {g} degree 2 {label} (z chunk {chunk}): kernel "
                  f"{k_ms:.4f} ms ({nbytes / 1e6 / k_ms:.0f} GB/s of {nbytes / 1e6:.1f} MB; bound "
                  f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / k_ms:.1%} of it), twin "
                  f"{p_ms:.4f} ms [{card}]")
    for tag, fn in (("MGCG 2-D 1023^2 solve", solve2), ("MGCG 3-D 255^3 solve", solve3)):
        walls[tag] = time_ms(fn, 3)
        print(f"time {tag}: {walls[tag]:.3f} ms [{card}]")
    _device_time_top(solve3, walls["MGCG 3-D 255^3 solve"], card)
    print(f"time plain CG 2-D solve: {time_ms(plain, 3):.3f} ms [{card}]")
    _dia_times(fsys.A, dev, card, times)
    _var_times(hj, dev, card, times)
    lib, bounds = _library_and_bounds(ops, fsys, sysj, hj, dev, card, times)
    _acc_times(sysj, acc_recs, dev, card, times, lib, bounds)
    _wide_times(wide_cases, dev, card, times, lib, bounds)
    t0 = time.perf_counter()
    _many_diag_times(many_cases, dev, card)
    _format_products(flagship_csr, dev, card)
    print(f"phase: times past 256 diagonals and of every format in {time.perf_counter() - t0:.1f} s")

    for tag, before in WALLS_BEFORE_MS.items():
        print(f"wall {tag}: {walls[tag]:.3f} ms now, {before} ms in two runs before the redesign "
              f"of kernels #1 and #5 [{card}]")

    # -- record -------------------------------------------------------------
    main_shape = {"spmv_const_stencil": ("spmv_const_stencil", GRID_3D),
                  "cheb_smooth_const": ("cheb_smooth_const", GRID_3D, "pre: zero x0 + resid"),
                  "spmv_dia": ("spmv_dia", "fp32"),
                  "spmm_dia": ("spmm_dia", 4, "fp32"),
                  "spmv_stencil": ("spmv_stencil", "255^3 7 legs", "fp32"),
                  "spmm_dia_acc": ("spmm_dia_acc", ACC_MAIN),
                  "spmv_stencil_wide": ("spmv_stencil_wide", "128^3 81 legs", "fp32")}
    record = [
        dict(name=name, **meta, launches=launches[name], launches_by_path=by_path[name],
             max_abs_err=errs[name], ms=times[main_shape[name]][0],
             plain_ms=times[main_shape[name]][1], bound_ms=bounds[name][0],
             bound_by=bounds[name][1], library_ms=lib[name])
        for name, meta in KERNELS.items()
    ]
    for r in record:
        _require(r["launches"] > 0, f"{r['name']}: no launch on its path")
    print(f"run: {time.perf_counter() - t_run:.1f} s after the build")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
