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
- The variable-coefficient path: ``diffusion_system((127,)*3, kind="jump",
  contrast=1e3)`` -> ``build_hierarchy`` (Galerkin: 127^3 with 7 legs, then
  27-leg levels, dense) -> ``api.solve(method="mgcg")`` in fp32 (cut from
  255^3, whose hierarchy's host setup took 71-90 s; the 255^3 jump
  system's fine level stays kernel #3's main shape, with no hierarchy);
  then ``diffusion_system((127,)*3, kind="smooth")`` ->
  ``refined_solve(grid=, matrix_dtype=torch.bfloat16)`` to an absolute
  ||r||_2 < 1e-8, host and device residual.  The counts show the
  variable-coefficient SpMV ran at every level, and on its bf16-leg
  instantiation as often as the iteration counts imply.
- The multi-RHS grid path: ``cg_solve_multi`` on the 127^3 jump system's DIA
  (the DIA SpMM at the CG level) with ``as_multi_preconditioner`` over its
  hierarchy, k = 4, column 0 the system's b (its iteration count must equal
  the single-RHS solve's); ``api.solve(B, method="mgcg")`` on 63^3 Poisson,
  card against CPU; ``refined_solve_multi(grid=, matrix_dtype=bf16)`` on the
  127^3 smooth system, k = 2 (column 0's counts must equal the single-RHS
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
- The formats slice.  Kernels #4 and #5 (k = 4) past 256 diagonals, fp32,
  bf16 legs and fp64, against their twins on the 16^3 levels of the 128^3
  (343 diagonals) and 256^3 (1331) hierarchies as DIA, in chained launches
  of the split form (each row's legs split across S threads, S printed;
  every SpMM column the SpMV's bit for bit); then
  ``api.solve(method="mgcg", layout="dia")`` on Poisson 128^3 fp32, #4 at
  every level (the 343-diagonal one in whole chains), its warm wall and
  device time, each level's #4 replayed from a CUDA graph beside
  cuSPARSE's, beside the stencil-layout solve.  The reference's own
  storage in fp64 with each workload's policy: the flagship as CSR
  through ``api.solve`` (cuSPARSE's product, no #4 launch; run twice,
  bit-identity printed) and through ``make_kernel_operator`` (#4 once per
  iteration and once more), then an n x 4 block; ``WORKLOADS["handmade_cl"]`` as diagonal-first ELL both
  ways.  Matrix Market: Poisson 63^3 fp32 permuted by a seeded symmetric
  permutation must load as CSR and solve with no #4 launch; Poisson 127^3
  unpermuted must load as DIA, solve on #4 and, as an n x 4 block, on #5.  Every
  format's SpMV and SpMM (k = 4) against the fp64 oracle, timed beside its
  bound, and #4/#5 past 256 diagonals timed beside cuSPARSE (both as
  launched and replayed from CUDA graphs; the record's ``split_by_shape``
  and ``past_256_diagonals``).
- The CG drivers.  On four paths (255^3 Poisson, 127^3 jump and 1024^2
  Galerkin MGCG in fp32, each as ``mgcg_solve`` runs it over the
  hierarchies built above; the flagship in fp64 through
  ``make_kernel_operator``, kernel #4), ``cg_solve`` against
  ``cg_solve_chunked`` (one CUDA graph per masked chunk) at chunk 1 and at
  chunk = the path's iteration count: equal iteration counts and converged
  flags, each within the path's true-residual bound, warm walls with the
  capture time apart, x's bit-identity, and a profiled chunk-1 solve in
  which the trace's graph launches ran exactly the captured step's kernel
  launches (the wrappers count a captured launch once) once per replay.
  Then a chunked 127^3 jump solve
  killed after its first chunk and resumed from its checkpoint file (the
  uninterrupted count), ``cg_solve_traced`` on the 255^3 Poisson MGCG
  (its history against the chunked residual), the 127^3 smooth hierarchy
  saved and loaded (``save_pytree``; the same count and x), and the
  ``reference_workloads`` twin at ``--quick`` in fp64 (every row OK).
- The preconditioners.  ``api.solve(method="amg_cg")`` fp32 on the two
  Poisson Matrix Market files of the ingestion phase: in natural
  order the setup infers the (127, 127, 127) grid and aggregates in cubes,
  every level launches its kernel (#1 on a const level, #3 on a variable
  one, by grid) and the outer CG runs #4 exactly iterations + 1 times;
  permuted, greedy aggregation (``native.aggregate``) gives CSR levels
  and no #1, #3 or #4 launch.  Each prints its levels, host setup by
  phase, iterations beside plain CG's, warm wall and profile; beside them
  ``mgcg`` on the same system and an n x 4 ``amg_cg`` block (column 0 the
  single-RHS count).  127^3 jump diffusion as CSR through ``amg_cg`` (#3 at
  every stencil level).  The flagship through plain CG, ``jacobi_cg``,
  ``bjacobi_cg``, ``cheb_cg`` and ``amg_cg`` (1-D strips, DIA levels), #4
  launched exactly as often as each route implies, and ``jacobi_cg`` /
  ``bjacobi_cg`` on n x 4 blocks (#5).  Each AMG level's kernel timed
  beside cuSPARSE.  31^3 card against CPU (equal fp64 counts), two greedy
  cycles bit-identical, the C++ aggregation against the Python loop; the
  spectrum tools (``spectrum_from_cg`` of a traced AMG-PCG run,
  ``condition_number``, ``gershgorin_bounds``, ``power_iteration`` on the
  card against host Lanczos, ``jacobi_eigenvalues`` of a 16 x 16 matrix).
- The nonsymmetric and indefinite Krylov family, fp32 ``rel_l2`` 1e-6
  through ``api.solve``: convection-diffusion 1023^2 at eps 0.05 by
  ``mg_bicgstab`` (the rediscretized hierarchy, #3 at every level),
  Jacobi-GMRES(32), ``mg_fgmres`` with inner BiCGStab and plain BiCGStab
  (capped, and not required to converge); IDR(4)
  through ``method="auto"`` at 127^2, eps 0.5, tol 2e-6 (auto must choose
  idr; its true residual within 10x of the one it reports);
  ``amg_bicgstab`` on a 511^2 convection CSR (the grid inferred, stencil
  levels on #3, no #4); the flagship's nonsymmetric twin (n = 207,402,
  band 160) by BiCGStab on #4, an n x 4 block on #5 (column 0 the
  single-RHS count) and ``refined_solve(inner="bicgstab")`` to an absolute
  fp64 ||r||_2 < 1e-8; Helmholtz 255^2 at 1.5 lambda_1 through auto
  (MINRES, fp64; the SPD probe's card stage decides).  Every route's #4 or
  #5 count equals what its recurrence implies, every converged route's
  true fp64 relative residual is within 1e-5, and each prints its warm
  wall and device busy share; then each solver in fp64 at about 63^2 on
  the card and on the CPU, equal counts and x within 1e-9.
- Least squares, s-step CG, deflation and adjoints, fp32 ``rel_l2`` 1e-6
  unless stated: the twin's host transpose on #4 (A^T x against its twin
  and cuSPARSE's product of the transpose's CSR, timed beside A x; the
  record's ``transposed_dia``), CGNR and LSMR on the twin through
  ``api.solve`` (#4 exactly 2 an iteration plus 5 and 3); LSMR through
  ``auto`` and damped on a seeded 524,288 x 131,072 sparse regression
  (cuSPARSE, no #4) against scipy's ``lsmr``: the true normal residual
  within 1e-5 and x within 2 kappa (rho + rho_scipy), kappa by Lanczos on
  the card; ``cacg`` (s = 4) and ``jacobi_cacg`` on the flagship and
  ``cacg`` on Poisson 1023^2 as DIA beside ``cg`` (1 + 2s #4 launches and
  two host reads an outer step; the true residual within 10x of the
  reported one); ``make_deflation`` on ``outlier_system(207402, 160)``
  (Lanczos on fp32 #4, AW on fp64 #4, setup by phase), ``deflated_cg``
  against ``cg``, a 5-RHS sequence whose probe plus deflated products
  beat plain CG's, ``refined_solve(deflation=)`` on the host and device
  routes below the undeflated inner count; ``cg_solve_implicit`` on the
  fp64 flagship and ``bicgstab_solve_implicit`` on the twin (its A^T from
  ``dia_transpose_traced`` equal to the host transpose) against central
  differences, the inverse demo to its goal; ``dd_dot``, ``kahan_sum`` and
  ``promote_dot`` on 16M fp32 elements against an fp64 witness, the
  compensated two on a cancelling input also 100x below the plain fp32
  reduction's error; warm walls the median of 5 calls; each new route in
  fp64 at small size on the card and the CPU.
- The eigensolvers: ``api.eigs(A, k=8, which="SM", grid=(511, 511),
  spd=True)`` on Poisson 511^2 in fp32 and fp64 (LOBPCG with the MGCG
  hierarchy's V-cycle per column: #5 on the (3k, n) block, #1 at every
  level), ``auto``'s probe timed apart on 511^2; the fp64 values within 1e-6 of the
  closed form, the fp32 ones within Rayleigh-quotient bounds of the fp64
  ones, true residuals, orthonormality, the warm wall's fixed cost split
  into the start blocks' draws on the card and their cast, A's placement
  and the rest; the generalized problem (a mass matrix B on #5
  too, a V-cycle M) on 255^2 in fp64 against scipy's ``eigsh(sigma=0)``;
  Krylov-Schur Arnoldi (#4 once per matvec) at the JAX package's eigen
  workload, convection-diffusion 511^2 eps 0.1 in fp32, LM and LR beside
  its artifact's values, and LM at 127^2 in fp64 against ARPACK;
  shift-invert at 63^2 (sigma = 0; inner IDR(4) on #4 with a V-cycle M at
  the default inner_tol; the recomputed residuals one #5 block product) in
  fp32 and fp64 against
  ARPACK's sigma = 0; each route's #4/#5 and V-cycle launches to the count
  its recurrence implies, warm walls the median of 3, busy shares; three
  routes in fp64 at small size on the card and the CPU; #5 at LOBPCG's 3k
  = 24 columns timed against its twin, cuSPARSE and the bound.
- The host kit and the batched solves.  ``native.available()`` (csrkit
  built, its OpenMP threads printed); csrkit's COO -> CSR, CSR -> DIA and
  CSR -> ELL on the flagship CSR equal to the port's numpy conversions,
  each timed beside numpy's, and on the HandmadeCL CSR (n = 345,678) the
  CSR back and the CSR's products;
  ``api.solve(method="native")`` on Poisson 127^3 fp64 (capped) with
  ``oracle.cg``'s count.  Batched kernel #4 and its fused p.Ap against the
  twin and, member by member, bit-equal to the single kernel: the flagship
  band at k = 1, 3, 8 in fp32 and fp64, 16^3 x 343 chained (split
  launches) at k = 4, a ragged n; each timed against its bound, k single
  launches and cuSPARSE's product of the members' block-diagonal CSR.
  ``cg_solve_batched`` on 8 flagship members (data x (1 + 0.1 j)) in fp32:
  each member's count equals ``cg_solve``'s, one fused batched launch an
  iteration, warm wall beside 8 sequential solves and the busy share.
  ``torch.func.vmap(torch.func.grad)`` through ``cg_solve_implicit`` (4
  flagship members, fp64) and ``bicgstab_solve_implicit`` (4 members of
  the twin) within 1e-10 of a loop of single gradients, on the batched #4
  only.
- The row-block-sharded CG, four shards on the one card (``make_mesh(4,
  devices=["cuda:0"] * 4)``: what sharding costs, not multi-GPU speed).
  ``make_distributed_system`` of the flagship per block (207,402 rows
  padded to 207,404) bit-equal to ``pad_system`` of the full build;
  ``sharded_cg_solve`` by cg, cg1, pipelined and cacg (s = 4) on 4 shards
  and on 1, fp64 at the workload's policy (pipelined and cacg at the
  policies of PAR_PIPE64 and PAR_CACG64) and fp32 at rel_l2 1e-6 from x0
  = 0: each count within 2 of the single-device solver's at the same
  policy, kernel #4 once per shard per product (to the count the
  recurrence implies), the true fp64 ``||r||_2`` below 1e-7 and within 4x
  scipy's textbook CG (fp64), the true relative residual below 1e-5
  (fp32); warm medians of 5 of the 4-shard, 1-shard and ``cg_solve``
  solves with their busy shares (no cuSPARSE kernel on the DIA path) and
  the halo bytes; ``api.solve(mesh=)`` by jacobi_cg, cacg and jacobi_cacg;
  sharded def-CG on the outlier system beside single-device def-CG;
  ``sharded_cg_solve_general`` on the flagship as CSR and HandmadeCL as
  ELL, their hops and routes.
- The multi-process mesh (``parallel.multihost``, ``parallel.comm``): one
  NCCL rank in this process (``initialize_distributed`` at world size 1,
  ``global_mesh`` over 4 shards of the card), the flagship's fp64 sharded
  CG with the parallel phase's count and x bit for bit; then the port's
  launcher (``scripts/multiprocess_demo.py``) with two ranks x 2 shards of
  the card over Gloo (NCCL refuses two ranks on one GPU; Gloo stages the
  CUDA parts through host buffers): ``viennacl_large`` by fp64 sharded CG
  (#4 a shard), each rank's own blocks against the fp64 oracle, and
  rung-5 Poisson 255^3 by probed MGCG (#3 a shard) against the same MGCG
  on a one-process 4-shard mesh here: the same count, the owned x blocks
  bit for bit, each rank's #3/#4 launches as the recurrences imply, the
  walls and the communicator's seconds.
- The sharded multigrid, on the same 4 shards and on 1:
  ``shard_mgcg_solve`` on Poisson 256^3 (the Galerkin hierarchy the
  facade builds for an even grid, shared with the MGCG above: hybrid
  levels with halo0 1 and 2, aggregation levels with halo0 2 and 3 on the
  wide kernel #3 a shard, the 16^3 level in the replicated tail) by cg,
  cg1 and pipelined, and on 1024^2 Galerkin with the Chebyshev and rbgs
  smoothers: each count within 2 of ``mgcg_solve``'s on the same
  hierarchy, the true fp64 relative residual below 1e-5, kernel #3 once a
  shard per sharded-level product and the tail's launches once (to the
  count the recurrence and the V-cycle imply), the 4-shard x within 1e-5
  of the 1-shard x; ``shard_multi_mgcg_solve`` on 1024^2 at k = 4 against
  ``cg_solve_multi``, each column's true residual below 1e-5;
  ``sharded_cg_multi_solve`` on the flagship padded to 4 | n, k = 4, cg
  and bicgstab (kernel #5 once a shard per block product);
  ``api.solve(mesh=)``: mgcg on 1023^2 (replicated: ``mgcg_solve``'s x bit
  for bit) and 256^3 (sharded), refined on 1024^2 to ||r||_2 < 1e-8 (the
  fp64 residual on kernel #4 once a shard per pass), (n, k) mgcg and cg;
  kernel #3 on one shard's extended 256^3 slab (its local rows against #3
  on the global rows and the twin) and #5 on one shard's flagship DIA at k
  = 4 (against the twin and #4 a column), each timed beside its bound and
  cuSPARSE; warm medians of the 4-shard, 1-shard and ``mgcg_solve`` 256^3
  solves with their busy shares.
- The sharded nonsymmetric family and the distributed AMG, on the same 4
  shards, on 1 and on one device through ``api.solve`` (``mesh=``):
  convection-diffusion 1024^2 at eps 0.05 by bicgstab (fp64: fp32
  BiCGStab breaks down there), jacobi_gmres(32), idr(4) and, over the
  rediscretized Jacobi hierarchy, mg_bicgstab and mg_gmres (the sharded
  V-cycle, #3 a shard at every level); MINRES on Helmholtz 256^2 at 1.5
  lambda_1 (fp64); LSMR and the Chebyshev block loop (check_every 16) on
  the flagship padded to 4 | n (#4 a shard on A, A^T and the extended
  DIA); amg_cg and amg_bicgstab on the preconditioners phase's 127^3
  natural hierarchy (per-shard CSR blocks on cuSPARSE, the replicated
  tail), and amg_cg with a tail that keeps its 15^3 stencil level (#3).
  Each run converged with the true fp64 relative residual below 1e-5 and
  its #1/#3/#4 launches as the recurrence and its V-cycles imply; the
  counts within 2 of each other and the 4-shard x within 1e-5 (fp32) /
  1e-9 (fp64) of the 1-shard x, but on BiCGStab and IDR, whose counts
  rounding decides on this operator: those are held to the one-device
  solves from b changed by one ulp (the counts within 10% of that range,
  the x within 4x its x spread); #4 on one shard of the convection and on
  one shard's Chebyshev-block extended DIA against its twin, timed beside
  its bound and cuSPARSE; warm medians of the mg_bicgstab solves and the
  busy shares of their 3-iteration windows.
- The eigensolvers over a mesh and the 2-D block partitions, on 4 shards of
  the card: ``api.eigs(mesh=)`` by LOBPCG on Poisson 1024^2 k = 8 in fp32
  (the sharded V-cycle as M; #5 once a shard a pass; the values within
  their Rayleigh-quotient bounds of the closed form and of the one-device
  eigs), ``gspmd_arnoldi_eigs`` LM k = 6 on convection 512^2 (#4 once a
  shard a matvec; against the one-device run); then on a (2, 2) mesh of
  the card beside the 1-D 4 shards: ``gspmd_mgcg`` on Poisson 256^3 and
  ``api.solve(method="mg_bicgstab", axes=("x", "y"))`` on convection
  1024^2 (the 1-D counts), ``gspmd_refined_solve`` on jump 512^2 (a true
  fp64 ||r||_2 under 1e-10, the outer residual on #3 in fp64 a block),
  ``build_hierarchy_probed(axes=("x", "y"))`` on 256^3 by plain
  aggregation (legs bit-equal to the 1-D build's, the same MGCG count); #3 on the extended 2-D blocks
  and #5 on a 1024^2 shard at k = 8 against their twins, timed (the
  record's ``block_2d`` and ``eig_shard``); warm walls and busy shares.
- Rung 5, on 4 shards of the card: Poisson 511^3 fp32 identity-padded to
  512 x 511 x 511 (133,432,831 real rows) and assembled slab by slab
  (``parallel.rung5.make_rung5_system``; the assembly's peak host bytes,
  by ``tracemalloc``, below two shards' slabs of legs and b), its
  hierarchy probed on the shards (``precond.distributed.
  build_hierarchy_probed``: #3 a shard a probe, a power-iteration step and
  a Rayleigh quotient, to the count the code implies; its device-to-host
  reads), MGCG with the padded plane masked (``make_rung5_mgcg(n_real=)``):
  converged, the true fp64 relative residual on the real rows below 1e-5
  (computed on the card by shard), the padded plane exactly 0, #3 as the
  recurrence implies, the warm median of 5 and the busy share; #3 on one
  shard's extended (130, 511, 511) x 7 slab against its twin, timed beside
  its bound and cuSPARSE (the record's ``rung5_slab``); the probed build
  against the host ``build_hierarchy(sa_smooth_levels=0)`` at 127^3 (the
  same levels and transfers, legs within 1e-5, MGCG counts within 1, both
  setup times); the rediscretized convection 256^3 eps 0.05
  (``build_hierarchy_redisc``, Jacobi) by mg BiCGStab to rel_l2 1e-5:
  converged, the true residual, #3 as implied, the warm wall.

Kernels #1 (every pattern and the run-time one, 1-D to 3-D, fp32 and fp64,
NaN-carved x), #5 (fp32, bf16 and fp64 legs) and #6 (fp32 and bf16 legs,
NaN-planted X at k = 3 and 8) are held to their twins first, and the ptxas
report of every instantiation of #1, #2, #3, #5, #6, the split #4 and the
batched #4 must
show a 0-byte stack frame and no spills; #6's blocks per SM and waves at
its main shapes are printed.

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
import contextlib
import copy
import dataclasses
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import tracemalloc
import types

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
    const_to_stencil,
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
from conjugategradient_tpu_torch.core.partition import pad_system
from conjugategradient_tpu_torch.models.workloads import WORKLOADS
from conjugategradient_tpu_torch.ops import _build, cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.ops.card import (
    SMS,
    blocks_per_sm,
    bound_ms,
    card_name,
    dia_csr,
    dia_nnz,
    graph_ms,
    spmm_bytes,
    time_ms,
)
from conjugategradient_tpu_torch.ops.cuda_dia import (
    TAGS,
    dia_groups,
    k_chunks,
    launch_counts,
    make_kernel_operator,
    spmm_dia_acc_cuda,
    spmm_dia_acc_ref,
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
    spmv_dot_dia_ref,
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
from conjugategradient_tpu_torch.parallel import (
    Shards,
    make_mesh,
    make_shard_mgcg,
    make_sharded_cg,
    make_sharded_cg_general,
    shard_multi_mgcg_solve,
    sharded_cg_solve,
)
from conjugategradient_tpu_torch.parallel import rung5
from conjugategradient_tpu_torch.parallel.halo import (
    HaloDia,
    exchange_bytes,
    extend_dia_data,
    extend_grid_rows,
    extend_rows,
)
from conjugategradient_tpu_torch.parallel.mesh import Mesh, shard_rows
from conjugategradient_tpu_torch.parallel.shard_mgcg import _const_legs
from conjugategradient_tpu_torch.parallel.shard_multi import sharded_cg_multi_solve
from conjugategradient_tpu_torch.parallel.multihost import make_distributed_system
from conjugategradient_tpu_torch.ops.spmv import as_operator, prepare
from conjugategradient_tpu_torch.precond import amg
from conjugategradient_tpu_torch.precond.distributed import (
    build_hierarchy_probed,
    build_hierarchy_redisc,
)
from conjugategradient_tpu_torch.precond.multigrid import (
    _const_bounds,
    _fused_cheb_ok,
    as_preconditioner,
    build_hierarchy,
    fmg,
    mgcg_solve,
)
from conjugategradient_tpu_torch.scripts import reference_workloads, spmm_acc_experiment
from conjugategradient_tpu_torch.scripts.probed_setup_bench import probed_vs_host
from conjugategradient_tpu_torch.solvers import eigen
from conjugategradient_tpu_torch.solvers.cg import cg_solve, cg_solve_chunked, cg_solve_traced
from conjugategradient_tpu_torch.solvers.multi import (
    as_multi_preconditioner,
    bicgstab_solve_multi,
    cg_solve_multi,
)
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi
from conjugategradient_tpu_torch.utils import PhaseTimer, load_pytree, load_state, save_pytree

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
#: the jump field's MGCG paths (fp32 MGCG, its k = 4 block, the chunked and
#: resumed drivers): cut from 255^3 to 127^3 when the sharded multigrid
#: joined the run (the 255^3 jump hierarchy's host setup took 71-90 s, most
#: of it power iteration); the 255^3 jump system stays for kernel #3's main
#: shape (its fine level, no hierarchy), #5 and #6
JUMP_MG_GRID = (127, 127, 127)
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
}

#: the rest of the multigrid build, at full size: Poisson 256^3 (hybrid
#: fine level, Galerkin levels of 81 to 1331 legs at |shift| 2 to 5; and
#: rediscretized,
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
#: the permuted Matrix Market file's grid: cut from MTX_GRID (its greedy
#: AMG took 40.6 s of host setup at 127^3) to keep the run inside its
#: time limit with the rung-5 phase
MTX_PERM_GRID = (63, 63, 63)
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
    # kernel #4 batched over k members of one sparsity: what jax.vmap makes of
    # _cm_kernel's pallas_call (:257) under the vmapped solves
    "spmv_dia_batched": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:193",
    ),
    "spmv_dot_dia_batched": dict(
        route="cuda", source="conjugategradient_tpu_torch/csrc/dia.cu",
        replaces="conjugategradient_tpu/ops/pallas_spmv.py:193",
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
        csr = dia_csr(DiaMatrix(Ak.data.to(vec), Ak.offsets, Ak.shape))
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
    """``api.solve(method="mgcg")`` on the jump system over its Galerkin
    hierarchy, counted (kernel #3 at every level), timed in a warm run,
    then profiled.  Returns kernel #3's launch count, the counted result
    and the warm wall (ms)."""
    grid = hj.levels[0].grid
    kw = dict(method="mgcg", grid=grid, tol=TOL, norm="rel_l2", dtype=np.float32, device=dev,
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
    tag = f"MGCG jump {grid}"
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


def _var_times(A7, A27, dev, card, times):
    """Kernel #3 vs its twin at the path's shapes: the 255^3 jump fine
    level (7 legs; fp32, bf16 and fp64 legs) and a 127^3 level of 27 legs
    (fp32 and bf16; built on the card), with GB/s from all leg bytes + x + y
    and the share of the bound (the leg entries whose neighbour lies in the
    grid)."""
    for label, A32, dtypes in (("255^3 7 legs", A7, LEG_DTYPES),
                               ("127^3 27 legs", A27, (torch.float32, torch.bfloat16))):
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


def _profile_rows(fn):
    """Run ``fn`` once under ``torch.profiler``: (the profiler, the profiled
    wall in ms, [(device us, launches, name)] of its device ops, largest
    first)."""
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
    return prof, prof_ms, rows


def _device_time_top(fn, wall_ms: float, card, top: int = 6, h=None):
    """Run ``fn`` once under ``torch.profiler`` and print the device time by
    kernel name (the ``top`` largest) beside the profiled wall, and the
    device's busy share of ``wall_ms``, the same work's unprofiled wall;
    with a hierarchy ``h``, the wide #3's device time by level too."""
    prof, prof_ms, rows = _profile_rows(fn)
    total_ms = sum(r[0] for r in rows) / 1e3
    wide = "" if h is None else f"; wide #3 device [ms, launches] by grid {_wide_by_grid(prof, h)}"
    print(f"profile: profiled wall {prof_ms:.3f} ms, device time {total_ms:.3f} ms in "
          f"{sum(r[1] for r in rows)} device ops, device busy {total_ms / wall_ms:.1%} of the "
          f"unprofiled wall {wall_ms:.3f} ms; top: "
          f"{[(k[:60], round(us / 1e3, 3), n) for us, n, k in rows[:top]]}{wide} [{card}]")


def _multi_mgcg(sysj, hj, single, dev, card):
    """Multi-RHS MGCG on the jump system: ``cg_solve_multi`` on its
    fp32 DIA (kernel #5 at the CG level) with ``as_multi_preconditioner``
    over its hierarchy (kernel #3 per column at every level), k = MULTI_K,
    column 0 the system's b; counted (the whole solve's profile was cut to
    make room for the multi-process phase).  Column 0 must take the single-RHS solve's iterations and agree with its
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
    tag = f"multi-RHS MGCG jump {hj.levels[0].grid} k={MULTI_K}"
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


def _library(name, lib_fn, kernel_out, card, reps):
    """Time one PyTorch call (the yardstick) after checking that it computes
    what the kernel computed."""
    err, scale = _max_err(lib_fn(), kernel_out)
    _require(err <= KERNEL_REL * scale, f"library call for {name}: max err {err:.3e} vs the kernel")
    ms = time_ms(lib_fn, reps)
    print(f"time library call for {name}: {ms:.4f} ms (max|library-kernel| {err:.3e}) [{card}]")
    return ms


def _library_and_bounds(ops, fsys, sysj, A3, dev, card, times):
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
    csr = dia_csr(sysj.A.device_put(torch.float32, dev))
    lib["spmv_stencil"] = _library("spmv_stencil 255^3 7 legs fp32", lambda: csr @ x.reshape(-1),
                                   spmv_stencil_cuda(A3, x).reshape(-1), card, 50)
    bounds["spmv_stencil"] = bound_ms(A3.nnz * 4 + 2 * n3 * 4, 2 * A3.nnz)
    del csr
    A = fsys.A.device_put(torch.float32, dev)
    nnz = dia_nnz(A)
    csr = dia_csr(A)
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
        csr = dia_csr(DiaMatrix(A.data.float(), A.offsets, A.shape))
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


def _hierarchy_on_thread(label, s, grid):
    """``_kind_hierarchy`` on a host thread: ``build_hierarchy`` runs on
    the host (scipy's sparse products release the GIL) while the card runs
    the phases before the hierarchy's first use.  Returns ``join(dev)``,
    which waits for the thread, places the hierarchy on ``dev`` and prints
    it as ``_kind_hierarchy`` does, with the seconds the caller waited."""
    box = {}

    def build():
        try:
            t0 = time.perf_counter()
            box["h"] = build_hierarchy(s.A, grid, dtype=np.float32, device="cpu")
            box["s"] = time.perf_counter() - t0
        except BaseException as e:  # re-raised by join
            box["err"] = e

    thread = threading.Thread(target=build, name=f"hierarchy {label}", daemon=True)
    thread.start()

    def join(dev):
        t0 = time.perf_counter()
        thread.join()
        if "err" in box:
            raise box["err"]
        waited = time.perf_counter() - t0
        h = box["h"].to(dev)
        torch.cuda.synchronize()
        print(f"hierarchy {label}: levels (grid, transfer, operator, legs, max |shift|) "
              f"{_describe(h)} + dense {h.coarse_inv.shape[0]}; host setup s "
              f"{ {k: round(v, 3) for k, v in h.setup_s.items()} } (total {box['s']:.3f} s on a "
              f"host thread beside the earlier phases; waited for {waited:.3f} s, upload "
              f"{time.perf_counter() - t0 - waited:.3f} s)")
        return h

    return join


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
    return dia_csr(DiaMatrix(vals, offs, (A.n, A.n)))


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


def _level_on_card(grid, shifts, dev, seed):
    """A variable-coefficient level of ``grid`` on ``shifts`` built on the
    card: legs drawn in [0.5, 1.5), zero where the neighbour leaves the
    grid (the layout of a Galerkin level, without the host setup)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    legs = torch.rand((len(shifts),) + tuple(grid), generator=gen, device=dev) + 0.5
    for k, sh in enumerate(shifts):
        for ax, d in enumerate(sh):
            if d:
                legs[k].narrow(ax, grid[ax] - d if d > 0 else 0, abs(d)).zero_()
    return StencilMatrix(legs, tuple(tuple(s) for s in shifts), tuple(grid))


def _multigrid_kinds(galerkin3, dev, card, errs, count):
    """The rest of the multigrid build at full size, each path counted
    (``count``), the wide kernel #3 checked against its twin at the paths'
    shapes first.  Returns the wide kernel's timing cases, the 1024^2
    Galerkin system with its hierarchy, and the 256^3 Poisson system with
    its Galerkin hierarchy (the sharded multigrid's 3-D case).
    ``galerkin3``: the 256^3 system and the ``join`` of its hierarchy's
    thread (``_hierarchy_on_thread``)."""
    h64 = _kind_small_card_vs_cpu(dev)
    s3, join = galerkin3
    h3g = join(dev)
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

    for label, s, grid, h in ((f"MGCG Galerkin Poisson {KIND_GRID_3D}", s3, KIND_GRID_3D, h3g),
                              (f"MGCG Galerkin Poisson {KIND_GRID_2D}", s2, KIND_GRID_2D, h2g)):
        counts, _ = _kind_mgcg(label, s, grid, h, dev, card)
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
            for i, (label, A) in enumerate(wide)], (s2, h2g), (s3, h3g)


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
    past 256 diagonals, fp32, bf16 legs and fp64, on NaN-buffered vectors;
    each call must launch once per group of ``dia_groups`` (and column
    chunk), by the split kernels where ``dia_plan`` splits the rows' legs,
    and each column of the SpMM must equal the SpMV of that column bit for
    bit.  Returns {label: the plan's S}."""
    rng = np.random.default_rng(SEED + 3)
    splits = {}
    for label, A_host in cases:
        groups = len(dia_groups(A_host.ndiags))
        splits[label] = cuda_dia.dia_plan(A_host.n, A_host.ndiags).split
        for legs in (torch.float32, torch.bfloat16, torch.float64):
            A = A_host.device_put(legs, dev)
            vec = torch.float64 if legs == torch.float64 else torch.float32
            rel = KERNEL_REL64 if legs == torch.float64 else KERNEL_REL
            tag = f"{label} {TAGS[legs]}"
            x = _nan_buffered(torch.from_numpy(rng.standard_normal(A.n)).to(dev, vec))
            X = _nan_buffered(torch.from_numpy(rng.standard_normal((MANY_K, A.n))).to(dev, vec))
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
            for j in range(MANY_K):
                _require(torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous())),
                         f"spmm_dia {tag}: column {j} is not the SpMV of column {j} bit for bit")
            errs["spmv_dia"] = max(errs["spmv_dia"], err)
            if legs != torch.float64:
                errs["spmm_dia"] = max(errs["spmm_dia"], errY)
            print(f"spmv_dia / spmm_dia {tag} ({A.ndiags} diagonals in {groups} chained groups, "
                  f"S = {splits[label]}): max|kernel-twin| {err:.3e} (max|twin| {scale:.3e}), fused "
                  f"p.Ap err {dot_err:.3e}, k={MANY_K} {errY:.3e}, every column the SpMV's bit for "
                  f"bit; launches {launches}")
    return splits


def _dia_layout_mgcg(wide_cases, dev, card, errs, count):
    """The repair's path.  The DIA-layout Galerkin hierarchy of Poisson
    DIA_MGCG_GRID in fp32 (levels of 7, 81, 125 and 343 diagonals); kernels
    #4 and #5 against their twins on its 343-diagonal level and on the 256^3
    hierarchy's 16^3 level as DIA (1331 diagonals); then
    ``api.solve(method="mgcg", layout="dia")``, counted: #4 at every level,
    the 343-diagonal one in chained groups, beside the stencil-layout
    solve's iteration count; its warm wall, device time and each level's
    #4 beside cuSPARSE.  Returns the (label, host DIA) cases and {label:
    the split's S}."""
    g = DIA_MGCG_GRID
    s = _kind_system("poisson", g)
    h = _kind_hierarchy(f"Galerkin Poisson {g} layout dia", s, g, dev, layout="dia")
    many = [lvl.A for lvl in h.levels if lvl.A.ndiags > cuda_dia.MAX_DIAGS]
    _require([A.ndiags for A in many] == [DIA_MGCG_MANY], f"{g} layout dia: levels {_describe(h)}")
    w1331 = next(A for label, A, _ in wide_cases if A.nlegs == 1331)
    cases = [(f"{g[0]}^3 hierarchy's 16^3 level", to_host(many[0])),
             (f"{KIND_GRID_3D[0]}^3 hierarchy's 16^3 level as DIA", stencil_to_dia(to_host(w1331)))]
    splits = _many_diag_checks(cases, dev, errs)
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
    t0 = time.perf_counter()
    api.solve(s.A, s.b, hierarchy=h, layout="dia", **kw)
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t0) * 1e3
    print(f"time {tag} api.solve: {res.iterations} iterations, counted run {wall * 1e3:.3f} ms, "
          f"warm run {warm_ms:.3f} ms [{card}]")
    _device_time_top(lambda: api.solve(s.A, s.b, hierarchy=h, layout="dia", **kw), warm_ms, card)
    _dia_level_times(h, by_shape, dev, card)
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
    return cases, splits


def _dia_level_times(h, by_shape, dev, card):
    """Kernel #4 on each level of the DIA-layout hierarchy ``h`` (fp32, as
    the solve runs it), replayed from a CUDA graph beside cuSPARSE's CSR
    product replayed the same way, the bound, and the level's launches in
    one solve (``by_shape``)."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 8)
    for lvl in h.levels:
        A = lvl.A
        x = torch.randn(A.n, generator=gen, device=dev, dtype=A.data.dtype)
        csr = dia_csr(A)
        y = spmv_dia_cuda(A, x)
        err, scale = _max_err(csr @ x, y)
        _require(err <= KERNEL_REL * scale, f"level {lvl.grid}: CSR differs from #4 by {err:.3e}")
        nnz, size = dia_nnz(A), A.data.element_size()
        nbytes = nnz * size + 2 * A.n * size
        bound = bound_ms(nbytes, 2 * nnz)
        k_ms, c_ms = graph_ms(lambda: spmv_dia_cuda(A, x), 200), graph_ms(lambda: csr @ x, 200)
        plan = cuda_dia.dia_plan(A.n, A.ndiags)
        print(f"time spmv_dia {DIA_MGCG_GRID[0]}^3 DIA level {lvl.grid} {A.ndiags} diagonals fp32 "
              f"(S = {plan.split}, {len(plan.groups)} launches a call): graph {k_ms:.4f} ms, CSR "
              f"graph {c_ms:.4f} ms; {nbytes / 1e6:.2f} MB, bound {bound[0]:.4f} ms by {bound[1]}, "
              f"{bound[0] / k_ms:.1%} of it; {by_shape.get((A.n, A.ndiags), 0)} launches per solve "
              f"[{card}]")


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
    CSR, HandmadeCL's and (iterations, scipy's witness at that count)."""
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
    witness = (res.iterations, r_w)
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
    hcsr = dia_to_csr(hsys.A)
    ell = csr_to_ell(hcsr)
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
    return csr, hcsr, witness


def _ingestion(dev, card, count):
    """Poisson fp32 through Matrix Market files: MTX_PERM_GRID permuted by
    a seeded symmetric permutation must load as CSR (the blowup guard sees
    ~n diagonals) and solve with 0 kernel #4 launches; MTX_GRID unpermuted
    must load as DIA and solve on kernel #4, then as an n x 4 block on #5.
    Each solve ``rel_l2 < TOL``, true fp64 relative residual within
    TRUE_REL.  Returns {"permuted" / "unpermuted": (loaded matrix, b, plain
    CG's iterations)} for the preconditioners phase."""
    loaded = {}
    s = generators.poisson_system(MTX_GRID, dtype=np.float32)
    sp_ = generators.poisson_system(MTX_PERM_GRID, dtype=np.float32)
    perm = np.random.default_rng(SEED).permutation(sp_.n)
    t0 = time.perf_counter()
    permuted = from_scipy(to_scipy(sp_.A)[perm][:, perm])
    perm_s = time.perf_counter() - t0
    kw = dict(method="cg", tol=TOL, norm="rel_l2", dtype=np.float32, device=dev, precise_dot=True)
    with tempfile.TemporaryDirectory() as d:
        for label, g, A_file, b, kind in (
                ("permuted", MTX_PERM_GRID, permuted, sp_.b[perm], CsrMatrix),
                ("unpermuted", MTX_GRID, s.A, s.b, DiaMatrix)):
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
            loaded[label] = (A, b, res.iterations)
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
    print(f"Poisson {MTX_PERM_GRID}: symmetric permutation of the matrix {perm_s:.3f} s")
    return loaded


# -- the preconditioners and the spectrum tools ------------------------------

#: the 31^3 card-against-CPU checks; the Jacobi-rotation matrix's order
#: (cut from 16, 8.8 s on the card, to keep the run inside its time limit)
PRECOND_SMALL = (31, 31, 31)
JACOBI_EIG_N = 12
#: jacobi_eigenvalues against numpy's eigvalsh, fp64, relative to the
#: largest |eigenvalue|
JACOBI_EIG_REL = 1e-8
#: the card's power iteration against host Lanczos's upper end
POWER_ITERS = 200
POWER_AGREE = 1e-2
#: Lanczos steps of the spectrum probes: the JAX package's default k = 30
#: cut to 15 (the two host Lanczos runs on the flagship took 17.2 s each)
#: to keep the run inside its time limit; 15 steps put the upper end 0.09%
#: below 200 power-iteration steps' (a CPU run)
LANCZOS_K = 15


@contextlib.contextmanager
def _facade_built(module, name):
    """Collect what ``module.name`` builds (a hierarchy the facade makes,
    read afterwards for its levels and setup phases) by wrapping it for the
    block's duration."""
    built, orig = [], getattr(module, name)

    def build(*args, **kwargs):
        built.append(orig(*args, **kwargs))
        return built[-1]

    setattr(module, name, build)
    try:
        yield built
    finally:
        setattr(module, name, orig)


def _facade_amg():
    """``_facade_built`` of ``precond.amg.build_amg_hierarchy``."""
    return _facade_built(amg, "build_amg_hierarchy")


def _amg_levels(h):
    """[(level operator type, n, its size)] of an AMG hierarchy."""
    out = []
    for lvl in h.levels:
        A = lvl.A
        size = {DiaMatrix: lambda: f"{A.ndiags} diagonals", CsrMatrix: lambda: f"{A.nnz} nnz",
                StencilMatrix: lambda: f"{A.nlegs} legs",
                ConstStencilMatrix: lambda: f"{A.nlegs} const legs"}[type(A)]()
        out.append((type(A).__name__, A.n, getattr(A, "grid", None), size))
    return out


def _amg_launches():
    """Launches since the last reset: #1 and #3 (tuned and wide) by grid,
    #4 in all and by (n, ndiags), #5."""
    by3 = collections.Counter(spmv_stencil_cuda.launches_by_grid)
    by3.update(spmv_stencil_wide_cuda.launches_by_grid)
    return dict(const_by_grid=dict(spmv_const_stencil_cuda.launches_by_grid), var_by_grid=dict(by3),
                spmv_dia=spmv_dia_cuda.launches, dia_by_shape=dict(spmv_dia_cuda.launches_by_shape),
                spmm_dia=spmm_dia_cuda.launches)


def _cycle_dia_launches(h) -> int:
    """Kernel #4 launches of one cycle of ``h``: on each DIA level the
    smoothers' products (degree + 1 per Chebyshev sweep), the residual and
    the smoothed transfers' two."""
    per = 0
    for lvl in h.levels:
        if isinstance(lvl.A, DiaMatrix):
            groups = len(cuda_dia.dia_plan(lvl.A.n, lvl.A.ndiags).groups)
            smooth = sum(s + 1 for s in (h.pre, h.post) if s > 0)
            per += groups * (smooth + 1 + (2 if lvl.sa_c else 0))
    return per


def _require_level_launches(tag, h, got):
    """Every stencil level of ``h`` launched its kernel (#1 const, #3
    variable) at its grid."""
    for lvl in h.levels:
        A = lvl.A
        if isinstance(A, ConstStencilMatrix):
            _require(got["const_by_grid"].get(A.grid, 0) > 0, f"{tag}: no kernel #1 launch at {A.grid}")
        elif isinstance(A, StencilMatrix):
            _require(got["var_by_grid"].get(A.grid, 0) > 0, f"{tag}: no kernel #3 launch at {A.grid}")


def _amg_solve(tag, A, b, dev, card, **kw):
    """``api.solve(method="amg_cg")`` fp32 ``rel_l2 < TOL`` on the card,
    counted from a reset: converged, true fp64 relative residual within
    TRUE_REL, every stencil level's kernel launched; prints the levels,
    the host setup by phase, the wall, the warm wall (the built hierarchy)
    and its profile.  Returns (result, hierarchy, launches, warm ms)."""
    with _facade_amg() as built:
        _reset_counts()
        t0 = time.perf_counter()
        res = api.solve(A, b, method="amg_cg", tol=TOL, norm="rel_l2", dtype=np.float32,
                        device=dev, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    got = _amg_launches()
    h = built[-1]
    _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
    rel = _host_rel_residual(A, b, res.x.cpu().numpy())
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    _require_level_launches(tag, h, got)
    setup = h.setup_s
    print(f"{tag}: levels {_amg_levels(h)} + dense {h.coarse_inv.shape[0]}; host setup s "
          f"{ {k: round(v, 3) for k, v in setup.items()} } (total {sum(setup.values()):.3f} s); "
          f"api.solve(method='amg_cg') {res.iterations} iterations, true fp64 rel residual "
          f"{rel:.3e}, wall {wall:.3f} s with the setup; launches: #1 by grid "
          f"{got['const_by_grid']}, #3 by grid {got['var_by_grid']}, #4 {got['spmv_dia']} "
          f"[{card}]")
    A_dev = A.device_put(torch.float32, dev)
    b_dev = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    M = amg.amg_preconditioner(h)
    warm = lambda: cg_solve(A_dev, b_dev, policy=ConvergencePolicy(tol=TOL, norm="rel_l2"), M=M)
    warm_ms = time_ms(warm, 3)
    print(f"time {tag} warm solve (hierarchy built): {warm_ms:.3f} ms [{card}]")
    _device_time_top(warm, warm_ms, card, top=8)
    return res, h, got, warm_ms


def _amg_level_times(tag, h, dev, card):
    """Each stencil and DIA level's kernel (#1, #3, #4) replayed from a CUDA
    graph, beside its twin, its bound and cuSPARSE's CSR product of the
    same operator replayed the same way, fp32 as the cycle runs it."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    for lvl, (_, _, _, size) in zip(h.levels, _amg_levels(h)):
        A = lvl.A
        if isinstance(A, CsrMatrix):
            continue
        shape = A.grid if isinstance(A, (StencilMatrix, ConstStencilMatrix)) else (A.n,)
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        if isinstance(A, ConstStencilMatrix):
            name, fn, ref = "spmv_const_stencil", spmv_const_stencil_cuda, spmv_const_stencil_ref
            csr = _stencil_csr(const_to_stencil(A).device_put(torch.float32, dev))
            nbytes, nnz = 2 * A.n * 4, A.nnz
        elif isinstance(A, StencilMatrix):
            name, fn, ref = "spmv_stencil", spmv_stencil_cuda, spmv_stencil_ref
            csr = _stencil_csr(A)
            nbytes, nnz = A.nnz * A.data.element_size() + 2 * A.n * 4, A.nnz
        else:
            name, fn, ref = "spmv_dia", spmv_dia_cuda, spmv_dia_ref
            csr = dia_csr(A)
            nnz = dia_nnz(A)
            nbytes = nnz * A.data.element_size() + 2 * A.n * 4
        y = fn(A, x)
        err, scale = _max_err(y, ref(A, x))
        _require(err <= KERNEL_REL * scale, f"{tag} level {shape}: {name} differs from its twin by {err:.3e}")
        bound = bound_ms(nbytes, 2 * nnz)
        k_ms = graph_ms(lambda: fn(A, x), 200)
        c_ms = graph_ms(lambda: csr @ x.reshape(-1), 200)
        p_ms = time_ms(lambda: ref(A, x), 20)
        print(f"time {name} {tag} level {shape} ({size}, fp32): "
              f"graph {k_ms:.4f} ms, twin {p_ms:.4f} ms, CSR graph {c_ms:.4f} ms; "
              f"{nbytes / 1e6:.2f} MB, bound {bound[0]:.4f} ms by {bound[1]}, "
              f"{bound[0] / k_ms:.1%} of it [{card}]")
        del csr


def _flagship_preconditioned(fsys, dev, card, count):
    """The flagship (a DiaMatrix, fp32 ``rel_l2 < TOL``) through api.solve
    by plain CG and by ``jacobi_cg``, ``bjacobi_cg`` (block 8), ``cheb_cg``
    (degree 3) and ``amg_cg`` (1-D strips, DIA levels): each converged
    within TRUE_REL, kernel #4's launches exactly the route's count; then
    ``jacobi_cg`` and ``bjacobi_cg`` on an n x MULTI_K block (#5), column 0
    the single-RHS count.  Returns the AMG hierarchy."""
    A, b = fsys.A, fsys.b
    kw = dict(tol=TOL, norm="rel_l2", dtype=np.float32, device=dev)
    its, h = {}, None
    for method, extra in (("cg", {}), ("jacobi_cg", {}), ("bjacobi_cg", dict(block_size=8)),
                          ("cheb_cg", dict(degree=3)), ("amg_cg", {})):
        with _facade_amg() as built:
            _reset_counts()
            t0 = time.perf_counter()
            res = api.solve(A, b, method=method, **kw, **extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n4 = spmv_dia_cuda.launches
        tag = f"flagship {method}"
        _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
        rel = _host_rel_residual(A, b, res.x.cpu().numpy())
        _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
        per_apply = 1  # the outer CG's product; the preconditioner's below
        levels = ""
        if method == "cheb_cg":
            per_apply += extra["degree"] + 1
        elif method == "amg_cg":
            h = built[-1]
            _require(all(isinstance(l.A, DiaMatrix) and l.blk for l in h.levels),
                     f"{tag}: levels {_amg_levels(h)} are not all DIA strips")
            per_apply += _cycle_dia_launches(h)
            levels = (f"; levels {_amg_levels(h)} + dense {h.coarse_inv.shape[0]}, host setup s "
                      f"{ {k: round(v, 3) for k, v in h.setup_s.items()} }")
        want = per_apply * (res.iterations + 1)
        _require(n4 == want, f"{tag}: {n4} spmv_dia launches, the route implies {want}")
        its[method] = res.iterations
        count(f"preconditioners: flagship api.solve(method={method!r})", {"spmv_dia": n4})
        print(f"{tag}: {res.iterations} iterations (plain CG {its['cg']}), true fp64 rel residual "
              f"{rel:.3e}, spmv_dia launches {n4} = {per_apply} x (iterations + 1), wall "
              f"{wall:.3f} s with the setup{levels} [{card}]")
    rng = np.random.default_rng(SEED + 10)
    B = np.column_stack([b] + [rng.standard_normal(fsys.n) for _ in range(MULTI_K - 1)])
    for method in ("jacobi_cg", "bjacobi_cg"):
        _reset_counts()
        res = api.solve(A, B, method=method, **kw)
        torch.cuda.synchronize()
        cols = res.iterations.cpu().tolist()
        tag = f"flagship {method} n x {MULTI_K}"
        _require(bool(res.converged.all()) and spmm_dia_cuda.launches > 0,
                 f"{tag}: converged {res.converged.tolist()}, {spmm_dia_cuda.launches} spmm_dia launches")
        _require(cols[0] == its[method], f"{tag}: column 0 took {cols[0]} iterations, the "
                 f"single-RHS solve {its[method]}")
        X = res.x.cpu().numpy()
        rels = [_host_rel_residual(A, B[:, j], X[:, j]) for j in range(MULTI_K)]
        _require(max(rels) <= TRUE_REL, f"{tag}: true fp64 relative residuals {rels}")
        count(f"preconditioners: flagship api.solve(B n x {MULTI_K}, method={method!r})",
              {"spmm_dia": spmm_dia_cuda.launches})
        print(f"{tag}: iterations by column {cols}, spmm_dia launches {spmm_dia_cuda.launches}, "
              f"true fp64 rel residuals {[float(f'{r:.3e}') for r in rels]}")
    return h


def _card_vs_cpu_amg(perm_h, dev, card):
    """31^3 Poisson as CSR: fp64 ``amg_cg`` on the card and on the CPU take
    equal iteration counts; two cycles of the permuted MTX_PERM_GRID
    greedy hierarchy on the card give the same bits; the C++ aggregation equals
    the Python loop on the permuted 31^3 strength graph bit for bit."""
    g = PRECOND_SMALL
    s = generators.poisson_system(g)
    A = from_scipy(to_scipy(s.A))
    kw = dict(method="amg_cg", tol=TOL, norm="rel_l2", dtype=np.float64)
    rg, rc = api.solve(A, s.b, device=dev, **kw), api.solve(A, s.b, device="cpu", **kw)
    dx = float((rg.x.cpu() - rc.x).abs().max() / rc.x.abs().max())
    _require(rg.converged and rg.iterations == rc.iterations,
             f"AMG {g} fp64: {rg.iterations} iterations on the card, {rc.iterations} on the CPU")
    r = torch.randn(perm_h.levels[0].A.n, generator=torch.Generator(device=dev).manual_seed(SEED),
                    device=dev)
    y1, y2 = amg.amg_vcycle(perm_h, r), amg.amg_vcycle(perm_h, r)
    _require(bool(torch.equal(y1, y2)), f"two greedy AMG cycles differ by {float((y1 - y2).abs().max()):.3e}")
    perm = np.random.default_rng(SEED).permutation(s.n)
    S = amg._strength_graph(to_scipy(s.A)[perm][:, perm].tocsr(), 0.0)
    t0 = time.perf_counter()
    native = amg._aggregate(S, impl="native")
    t1 = time.perf_counter()
    loop = amg._aggregate(S, impl="python")
    t2 = time.perf_counter()
    _require(native[1] == loop[1] and np.array_equal(native[0], loop[0]),
             f"aggregation {g} permuted: C++ {native[1]} aggregates, Python loop {loop[1]}")
    print(f"AMG {g} CSR fp64: card {rg.iterations} its, CPU {rc.iterations} its, max rel diff "
          f"{dx:.3e}; two greedy {MTX_PERM_GRID} cycles on the card bit-identical; aggregation of the "
          f"permuted {g} strength graph: C++ {t1 - t0:.4f} s, Python loop {t2 - t1:.3f} s, "
          f"{native[1]} aggregates, bit-identical [{card}]")


def _spectrum_tools(nat, fsys, dev, card):
    """``spectrum_from_cg`` of a traced 127^3 AMG-PCG run; the flagship's
    ``condition_number`` and ``gershgorin_bounds``; the card's
    ``power_iteration`` against host Lanczos's upper end; the Jacobi
    rotations of a 32 x 32 matrix against numpy, timed."""
    A, b, h, its = nat
    A_dev = A.device_put(torch.float32, dev)
    b_dev = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    res, _hist, (alphas, betas) = cg_solve_traced(
        A_dev, b_dev, policy=ConvergencePolicy(tol=TOL, norm="rel_l2"), M=amg.amg_preconditioner(h),
        num_steps=its, with_coefficients=True)
    lo, hi, kappa = eigen.spectrum_from_cg(alphas, betas, res.iterations)
    _require(res.iterations == its and 1.0 <= kappa < 1e3,
             f"traced AMG-PCG: {res.iterations} iterations (counted {its}), kappa {kappa:.3e}")
    print(f"spectrum_from_cg, Poisson {MTX_GRID} .mtx AMG-PCG traced over {its} steps: "
          f"kappa(M^-1 A) {kappa:.4f} (Ritz [{lo:.4f}, {hi:.4f}])")
    t0 = time.perf_counter()
    kappa_f = eigen.condition_number(fsys.A, k=LANCZOS_K)
    t1 = time.perf_counter()
    g_lo, g_hi = eigen.gershgorin_bounds(fsys.A)
    l_lo, l_hi = eigen.lanczos_bounds(lambda v: oracle.spmv(fsys.A, v), fsys.n, LANCZOS_K)
    A64 = fsys.A.device_put(torch.float64, dev)
    t2 = time.perf_counter()
    lam = float(eigen.power_iteration(lambda v: spmv_dia_cuda(A64, v), fsys.n, iters=POWER_ITERS,
                                      seed=SEED, dtype=torch.float64, device=dev))
    t3 = time.perf_counter()
    _require(abs(lam - l_hi) <= POWER_AGREE * l_hi,
             f"power_iteration on the card {lam:.6e} vs Lanczos's upper end {l_hi:.6e}")
    _require(g_lo <= l_lo and l_hi <= g_hi * (1 + 1e-12), f"Lanczos [{l_lo}, {l_hi}] outside "
             f"Gershgorin [{g_lo}, {g_hi}]")
    print(f"flagship spectrum: condition_number {kappa_f:.6e} (host Lanczos k = {LANCZOS_K}, "
          f"{t1 - t0:.3f} s), gershgorin_bounds [{g_lo:.6e}, {g_hi:.6e}], Lanczos "
          f"[{l_lo:.6e}, {l_hi:.6e}]; power_iteration on the card ({POWER_ITERS} steps, fp64, "
          f"{t3 - t2:.3f} s) {lam:.6e}, {abs(lam - l_hi) / l_hi:.2e} from Lanczos [{card}]")
    rng = np.random.default_rng(SEED + 11)
    Q, _ = np.linalg.qr(rng.standard_normal((JACOBI_EIG_N, JACOBI_EIG_N)))
    M = (Q * rng.uniform(0.5, 50.0, JACOBI_EIG_N)) @ Q.T
    M = 0.5 * (M + M.T)
    t0 = time.perf_counter()
    ev = eigen.jacobi_eigenvalues(M, device=dev).cpu().numpy()
    secs = time.perf_counter() - t0
    ref = np.linalg.eigvalsh(M)
    err = float(np.abs(ev - ref).max() / np.abs(ref).max())
    _require(err <= JACOBI_EIG_REL, f"jacobi_eigenvalues {JACOBI_EIG_N} x {JACOBI_EIG_N}: {err:.3e} from eigvalsh")
    print(f"jacobi_eigenvalues {JACOBI_EIG_N} x {JACOBI_EIG_N} fp64 on the card: {secs:.3f} s, max "
          f"rel diff from numpy's eigvalsh {err:.3e} [{card}]")


def _preconditioners(loaded, fsys, dev, card, count):
    """The preconditioners and the spectrum tools on the card: Poisson
    MTX_GRID from the ingestion phase's two Matrix Market files through
    ``amg_cg`` (natural order: the grid inferred, cube levels on #1 and
    #3, the outer CG on #4 exactly iterations + 1 times; permuted: greedy
    CSR levels, no #1, #3 or #4), beside ``mgcg`` and plain CG, then an
    n x MULTI_K block; jump diffusion at 127^3 as CSR (#3 at every stencil
    level); the flagship by every preconditioned route; card against CPU;
    the spectrum tools.  Returns the natural-order system, its hierarchy
    and count (the sharded AMG reuses them)."""
    A_nat, b_nat, plain_nat = loaded["unpermuted"]
    tag = f"Poisson {MTX_GRID} .mtx natural order"
    res, h_nat, got, _ = _amg_solve(tag, A_nat, b_nat, dev, card)
    _require(h_nat.levels and h_nat.levels[0].blk_nd is not None
             and tuple(h_nat.levels[0].blk_nd[0]) == MTX_GRID,
             f"{tag}: the grid was not inferred: {h_nat.levels[0].blk_nd if h_nat.levels else None}")
    _require(all(l.blk_nd is not None for l in h_nat.levels), f"{tag}: not every level in cubes")
    want = res.iterations + 1 + (res.iterations + 1) * _cycle_dia_launches(h_nat)
    _require(got["spmv_dia"] == want, f"{tag}: {got['spmv_dia']} spmv_dia launches, want {want}")
    count(f"preconditioners: {tag} api.solve(method='amg_cg')",
          {"spmv_const_stencil": sum(got["const_by_grid"].values()),
           "spmv_stencil": sum(got["var_by_grid"].values()), "spmv_dia": got["spmv_dia"]})
    print(f"{tag}: amg_cg {res.iterations} iterations, plain CG {plain_nat} (ingestion phase)")
    _amg_level_times("Poisson 127^3 AMG", h_nat, dev, card)
    t0 = time.perf_counter()
    mg = api.solve(A_nat, b_nat, method="mgcg", grid=MTX_GRID, tol=TOL, norm="rel_l2",
                   dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    mg_s = time.perf_counter() - t0
    _require(mg.converged, f"{tag} mgcg: did not converge")
    print(f"{tag}: yardstick api.solve(method='mgcg', grid={MTX_GRID}) {mg.iterations} iterations, "
          f"wall {mg_s:.3f} s with the setup [{card}]")
    rng = np.random.default_rng(SEED + 12)
    B = np.column_stack([b_nat] + [rng.standard_normal(len(b_nat)) for _ in range(MULTI_K - 1)])
    _reset_counts()
    t0 = time.perf_counter()
    resB = api.solve(A_nat, B, method="amg_cg", tol=TOL, norm="rel_l2", dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    wallB = time.perf_counter() - t0
    gotB = _amg_launches()
    cols = resB.iterations.cpu().tolist()
    _require(bool(resB.converged.all()) and cols[0] == res.iterations,
             f"{tag} n x {MULTI_K}: converged {resB.converged.tolist()}, iterations {cols}, "
             f"single-RHS {res.iterations}")
    XB = resB.x.cpu().numpy()
    rels = [_host_rel_residual(A_nat, B[:, j], XB[:, j]) for j in range(MULTI_K)]
    _require(max(rels) <= TRUE_REL, f"{tag} n x {MULTI_K}: true fp64 relative residuals {rels}")
    _require(gotB["spmm_dia"] == max(cols) + 1 and gotB["spmv_dia"] == 0,
             f"{tag} n x {MULTI_K}: spmm_dia {gotB['spmm_dia']}, spmv_dia {gotB['spmv_dia']}")
    _require_level_launches(f"{tag} n x {MULTI_K}", h_nat, gotB)
    count(f"preconditioners: {tag} api.solve(B n x {MULTI_K}, method='amg_cg')",
          {"spmv_const_stencil": sum(gotB["const_by_grid"].values()),
           "spmv_stencil": sum(gotB["var_by_grid"].values()), "spmm_dia": gotB["spmm_dia"]})
    print(f"{tag} n x {MULTI_K} amg_cg: iterations by column {cols}, true fp64 rel residuals "
          f"{[float(f'{r:.3e}') for r in rels]}, spmm_dia launches {gotB['spmm_dia']}, wall "
          f"{wallB:.3f} s with the setup [{card}]")
    nat = (A_nat, b_nat, h_nat, res.iterations)

    A_perm, b_perm, plain_perm = loaded["permuted"]
    tag = f"Poisson {MTX_PERM_GRID} .mtx permuted"
    res, h_perm, got, _ = _amg_solve(tag, A_perm, b_perm, dev, card)
    _require(all(isinstance(l.A, CsrMatrix) and l.agg_rows is not None for l in h_perm.levels),
             f"{tag}: levels {_amg_levels(h_perm)} are not greedy CSR levels")
    _require(not got["const_by_grid"] and not got["var_by_grid"] and got["spmv_dia"] == 0,
             f"{tag}: stencil or DIA kernels launched: {got}")
    print(f"{tag}: amg_cg {res.iterations} iterations, plain CG {plain_perm} (ingestion phase)")
    del loaded

    g = MTX_GRID
    t0 = time.perf_counter()
    sj = generators.diffusion_system(g, kind="jump", contrast=VAR_CONTRAST, seed=SEED)
    A_j = from_scipy(to_scipy(sj.A))
    print(f"jump diffusion {g} as CSR ({A_j.nnz} nnz): generated and converted in "
          f"{time.perf_counter() - t0:.3f} s")
    tag = f"jump diffusion {g} CSR"
    res, h_j, got, _ = _amg_solve(tag, A_j, sj.b, dev, card)
    _require(any(isinstance(l.A, StencilMatrix) for l in h_j.levels), f"{tag}: no stencil level")
    count(f"preconditioners: {tag} api.solve(method='amg_cg')",
          {"spmv_const_stencil": sum(got["const_by_grid"].values()),
           "spmv_stencil": sum(got["var_by_grid"].values()), "spmv_dia": got["spmv_dia"]})
    _amg_level_times("jump 127^3 AMG", h_j, dev, card)
    del sj, A_j, h_j

    h_f = _flagship_preconditioned(fsys, dev, card, count)
    _amg_level_times("flagship AMG", h_f, dev, card)
    del h_f
    _card_vs_cpu_amg(h_perm, dev, card)
    del h_perm
    _spectrum_tools(nat, fsys, dev, card)
    return nat


def _many_diag_times(cases, dev, card):
    """Kernels #4 and #5 (k = MANY_K) past 256 diagonals, fp32 and fp64:
    kernel (as launched and from a CUDA graph), twin and cuSPARSE's CSR
    product (as launched and from a CUDA graph) beside the bound (the legs
    inside the matrix, x and y once).  Returns {op: {shape: the graph
    times, bound and library call}}."""
    rng = np.random.default_rng(SEED + 6)
    out = {}
    for label, A_host in cases:
        for legs in (torch.float32, torch.float64):
            A = A_host.device_put(legs, dev)
            n, nnz, size = A.n, dia_nnz(A), A.data.element_size()
            x = torch.from_numpy(rng.standard_normal(n)).to(dev, legs)
            X = torch.from_numpy(rng.standard_normal((MANY_K, n))).to(dev, legs)
            csr = dia_csr(A)
            tag = f"{label} {A.ndiags} diagonals {TAGS[legs]}"
            for op, k, fn, twin, lib in (
                    ("spmv_dia", 1, lambda: spmv_dia_cuda(A, x), lambda: spmv_dia_ref(A, x),
                     lambda: csr @ x),
                    ("spmm_dia", MANY_K, lambda: spmm_dia_cuda(A, X), lambda: spmm_dia_ref(A, X),
                     lambda: (csr @ X.T.contiguous()).T)):
                k_ms, g_ms, p_ms = time_ms(fn, 200), graph_ms(fn, 200), time_ms(twin, 5)
                lib_ms = _library(f"{op} {tag}", lib, fn(), card, 100)
                lib_g = graph_ms(lib, 100)
                nbytes = nnz * size + 2 * k * n * size
                bound = bound_ms(nbytes, 2 * k * nnz)
                out.setdefault(op, {})[f"{label} {TAGS[legs]}"] = dict(
                    ms=g_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=lib_g)
                print(f"time {op} {tag} k={k} (S = {cuda_dia.dia_plan(n, A.ndiags).split}): kernel "
                      f"{k_ms:.4f} ms (graph {g_ms:.4f}; {nbytes / 1e6:.1f} MB, bound "
                      f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / g_ms:.1%} of it from the "
                      f"graph), {len(dia_groups(A.ndiags))} launches a call, twin {p_ms:.4f} ms, "
                      f"CSR {lib_ms:.4f} ms (graph {lib_g:.4f}; the kernel's graph "
                      f"{lib_g / g_ms:.2f}x as fast) [{card}]")
    return out


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
    ELL and COO, Poisson DIA_MGCG_GRID as BSR_BLOCK blocks (its oracle
    product taken on the CSR it was blocked from, which the oracle would
    otherwise rebuild from the blocks for every product), banded_sin at DENSE_N rows as dense; and
    the flagship's CSR through kernel #4 (``make_kernel_operator``).  No
    format here is a TPU kernel: the JAX package runs them by XLA."""
    poisson = dia_to_csr(generators.poisson_system(DIA_MGCG_GRID).A)
    dense = dia_to_dense(generators.banded_sin_matrix(DENSE_N, 160))
    # (label, the container on the card, the container the oracle multiplies)
    ell, coo = csr_to_ell(csr), csr_to_coo(csr)
    cases = [("CSR flagship", csr, csr), ("ELL flagship", ell, ell), ("COO flagship", coo, coo),
             (f"BSR {BSR_BLOCK} Poisson {DIA_MGCG_GRID}", csr_to_bsr(poisson, BSR_BLOCK), poisson),
             (f"dense banded_sin n={DENSE_N}", dense, dense)]
    rng = np.random.default_rng(SEED + 7)
    for label, A_host, A_ref in cases:
        # the container the solvers run: a COO matrix as its row-sorted CSR
        # (the bytes are the CSR's)
        A_mm = prepare(A_host, dev)
        x_h, X_h = rng.standard_normal(A_mm.n), rng.standard_normal((A_mm.n, FORMAT_K))
        x, X = torch.from_numpy(x_h).to(dev), torch.from_numpy(X_h).to(dev)
        op = as_operator(A_mm)
        y, Y = op(x), spmm(A_mm, X)
        ref = oracle.spmv(A_ref, x_h)
        refY = np.column_stack([oracle.spmv(A_ref, X_h[:, j]) for j in range(FORMAT_K)])
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


# ---------------------------------------------------------------------------
# the CG drivers: cg_solve against cg_solve_chunked (one CUDA graph per
# masked chunk), checkpoint and resume, the traced driver, hierarchy
# persistence, the reference_workloads twin
# ---------------------------------------------------------------------------

#: a launch counter's name -> the kernel symbols it counts, as the
#: profiler's trace names them
KERNEL_SYMBOLS = {"spmv_const_stencil": "spmv_const_kernel", "cheb_smooth_const": "cheb_const_kernel",
                  "spmv_stencil": "spmv_var_kernel", "spmv_stencil_wide": "spmv_var_wide_kernel",
                  "spmv_dia": "spmv_dia_kernel", "spmv_dot_dia": "spmv_dot_dia_kernel",
                  "spmm_dia": "spmm_dia_kernel", "spmm_dia_acc": "spmm_dia_acc_kernel"}
#: the checkpoint path's chunk (shorter than the jump MGCG's count)
RESUME_CHUNK = 8
#: cg_solve_traced's steps on the 255^3 Poisson MGCG (5 iterations)
TRACED_STEPS = 8
#: the traced history against the chunked solve's residual (fp32, the same
#: recurrence, one reduction order)
TRACED_AGREE = 1e-6


class _Stop(Exception):
    """Simulated process death inside a chunked solve."""


def _driver_paths(h3, b3, sysj, hj, galerkin2, fsys, dev):
    """(tag, operator, b, x0, policy, M, precise_dot, fp32, true-residual
    check) of the four paths the drivers run: the 255^3 Poisson, 127^3 jump
    and 1024^2 Galerkin MGCG in fp32, each as ``mgcg_solve`` runs it, and
    the flagship in fp64 through ``make_kernel_operator`` (kernel #4)."""
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    s2, h2g = galerkin2
    gj = hj.levels[0].grid
    bj = torch.from_numpy(sysj.b.astype(np.float32)).to(dev).reshape(gj)
    b2 = torch.from_numpy(s2.b.astype(np.float32)).to(dev).reshape(KIND_GRID_2D)
    rel_bound = lambda A, b: lambda x: _host_rel_residual(A, b, x.reshape(-1).cpu().numpy()) <= TRUE_REL
    fpol = WORKLOADS[FLAGSHIP].policy
    return [
        (f"Poisson MGCG {GRID_3D}", h3.levels[0].A, b3, None, pol, as_preconditioner(h3), True, True,
         lambda x: _true_rel_residual(h3.levels[0].A, b3, x) <= TRUE_REL),
        (f"jump MGCG {gj}", hj.levels[0].A, bj, None, pol, as_preconditioner(hj), True, True,
         rel_bound(sysj.A, sysj.b)),
        (f"Galerkin MGCG {KIND_GRID_2D}", h2g.levels[0].A, b2, None, pol, as_preconditioner(h2g), True,
         True, rel_bound(s2.A, s2.b)),
        ("flagship fp64 via make_kernel_operator", make_kernel_operator(fsys.A, device=dev),
         torch.from_numpy(fsys.b).to(dev), torch.from_numpy(fsys.x0).to(dev), fpol, None, False, False,
         lambda x: _true_l2(fsys.A, fsys.b, x.cpu().numpy()) < FLAGSHIP_CG_TRUE),
    ]


def _replayed_kernels(prof):
    """{launch counter: kernels of its symbol in a profile that a CUDA graph
    launch ran}, matched by the correlation id of each ``cudaGraphLaunch``."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    launches = {e.get("args", {}).get("correlation") for e in events
                if e.get("cat") == "cuda_runtime" and "GraphLaunch" in e.get("name", "")}
    out = collections.Counter()
    for e in events:
        if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in launches:
            out.update(k for k, sym in KERNEL_SYMBOLS.items() if sym in e.get("name", ""))
    return dict(out)


def _on_card(counted, stats):
    """Launches that ran on the card in a chunked solve: the counted ones
    plus the captured chunk's once more for every replay after the first
    (a wrapper counts a captured launch once)."""
    per = stats["launches_per_chunk"]
    return {k: v + per.get(k, 0) * (stats["chunks"] - 1) for k, v in counted.items() if v}


def _drivers_path(path, dev, card, count):
    """``cg_solve`` against ``cg_solve_chunked`` at chunk 1 and at chunk =
    the path's iteration count: equal counts and converged flags, each
    within the path's true-residual bound; warm walls (each the second of
    two calls) with the capture time apart, x's bit-identity, and one
    profiled chunk-1 solve in which the trace's graph launches ran exactly
    the captured step's launches once per replay.  Returns cg_solve's
    result."""
    tag, A, b, x0, pol, M, precise, fp32, bound_ok = path
    kw = dict(policy=pol, M=M, precise_dot=precise)
    eager = lambda: cg_solve(A, b, x0, **kw)
    ref = eager()
    _require(ref.converged and bound_ok(ref.x), f"drivers {tag}: cg_solve failed its bound")
    n_it = ref.iterations
    t = PhaseTimer()
    eager()
    with t.phase("eager", sync=lambda: r):
        r = eager()
    line = []
    for chunk in (1, n_it):
        cg_solve_chunked(A, b, x0, chunk=chunk, **kw)
        stats = {}
        with t.phase(f"graph chunk {chunk}", sync=lambda: g):
            g = cg_solve_chunked(A, b, x0, chunk=chunk, stats=stats, **kw)
        _require(g.iterations == n_it and g.converged == ref.converged,
                 f"drivers {tag} chunk {chunk}: {g.iterations} iterations (converged {g.converged}), "
                 f"cg_solve {n_it} ({ref.converged})")
        _require(bound_ok(g.x), f"drivers {tag} chunk {chunk}: true residual over its bound")
        line.append(f"chunk {chunk}: {stats['chunks']} replays, capture {stats['capture_s'] * 1e3:.3f} "
                    f"ms, x bit-identical to cg_solve {bool(torch.equal(g.x, ref.x))}")
    print(f"drivers {tag}: {n_it} iterations both ways; {'; '.join(line)}")
    print(f"time drivers {tag}: {t.report(iterations=n_it)}; graph chunk {n_it} minus capture "
          f"{t[f'graph chunk {n_it}'] * 1e3 - stats['capture_s'] * 1e3:.3f} ms [{card}]")
    # the profiled solve replays a one-step graph once per iteration, so
    # the wrappers count only the capture's launches of the loop's kernels
    _reset_counts()
    stats = {}
    prof, prof_ms, rows = _profile_rows(
        lambda: cg_solve_chunked(A, b, x0, chunk=1, stats=stats, **kw))
    counted = {k: v for k, v in launch_counts().items() if v}
    on_card = _on_card(counted, stats)
    # the replays are checked exactly, by the kernels each graph launch
    # ran: late in this script's run the trace misses a few of a solve's
    # eager launches (its initial residual and warm-up step: 6 of 7 #1
    # and 68 of 70 #2 on 255^3 Poisson, 35 of 40 #1 on 1024^2 Galerkin in
    # every full run), while eight profiles of the 255^3 solve in a fresh
    # process saw all 77; the solve's totals are printed beside the trace's
    replayed = _replayed_kernels(prof)
    want = {k: v * stats["chunks"] for k, v in stats["launches_per_chunk"].items()}
    _require(stats["chunks"] == n_it and want and replayed == want,
             f"drivers {tag}: {stats['chunks']} replays of {stats['launches_per_chunk']} launches, "
             f"the trace's graph launches ran {replayed}")
    seen = {k: sum(n for _, n, key in rows if KERNEL_SYMBOLS[k] in key) for k in on_card}
    count(f"cg_solve_chunked {tag}", on_card, fp32=fp32)
    dev_ms = sum(r[0] for r in rows) / 1e3
    wall = t["graph chunk 1"] * 1e3
    print(f"profile drivers {tag} chunk 1: profiled wall {prof_ms:.3f} ms, device time "
          f"{dev_ms:.3f} ms, busy {dev_ms / wall:.1%} of the unprofiled wall {wall:.3f} ms; "
          f"launches: {stats['chunks']} graph replays ran {replayed} (the captured step's "
          f"{stats['launches_per_chunk']} each); counted {counted}, so on the card {on_card}, in "
          f"the trace {seen} [{card}]")
    return ref


def _resume_path(path, ref, card):
    """The jump MGCG chunked at RESUME_CHUNK: a callback kills the
    first call after one chunk, a second call resumes from the file and
    must take the uninterrupted chunked solve's count."""
    tag, A, b, x0, pol, M, precise, _, bound_ok = path
    kw = dict(policy=pol, M=M, precise_dot=precise, chunk=RESUME_CHUNK)
    whole = cg_solve_chunked(A, b, x0, **kw)
    _require(whole.iterations == ref.iterations, f"resume {tag}: {whole.iterations} iterations")

    def die(state):
        raise _Stop

    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "cg_state.npz")
        first = {}
        try:
            cg_solve_chunked(A, b, x0, checkpoint_path=ckpt, callback=die, stats=first, **kw)
        except _Stop:
            pass
        t0 = time.perf_counter()
        state = load_state(ckpt)
        load_s = time.perf_counter() - t0
        mb = os.path.getsize(ckpt) / 1e6
        rest = {}
        res = cg_solve_chunked(A, b, x0, checkpoint_path=ckpt, stats=rest, **kw)
    _require(state.iteration == RESUME_CHUNK, f"resume {tag}: the file holds iteration {state.iteration}")
    _require(res.converged and res.iterations == whole.iterations and bound_ok(res.x),
             f"resume {tag}: {res.iterations} iterations after the resume, {whole.iterations} whole")
    print(f"resume {tag} chunk {RESUME_CHUNK}: killed after iteration {state.iteration}, resumed to "
          f"{res.iterations} iterations (uninterrupted {whole.iterations}); x bit-identical "
          f"{bool(torch.equal(res.x, whole.x))}; state file {mb:.1f} MB, save {first['save_s']:.3f} s, "
          f"load {load_s:.3f} s; the resumed call's {rest['chunks']} saves {rest['save_s']:.3f} s [{card}]")


def _traced_path(path, ref):
    """``cg_solve_traced`` on the 255^3 Poisson MGCG: the history's entry at
    ``iterations - 1`` is the chunked solve's residual, the counts equal."""
    tag, A, b, x0, pol, M, precise, _, _ = path
    chunked = cg_solve_chunked(A, b, x0, policy=pol, M=M, precise_dot=precise, chunk=ref.iterations)
    res, hist, (alphas, betas) = cg_solve_traced(A, b, x0, pol, M, num_steps=TRACED_STEPS,
                                                 precise_dot=precise, with_coefficients=True)
    n_it = res.iterations
    h, want = float(hist[n_it - 1]), float(chunked.residual)
    _require(n_it == chunked.iterations == ref.iterations and res.converged,
             f"traced {tag}: {n_it} iterations, chunked {chunked.iterations}")
    _require(abs(h - want) <= TRACED_AGREE * want,
             f"traced {tag}: history[{n_it - 1}] {h:.6e}, chunked residual {want:.6e}")
    print(f"traced {tag}, {TRACED_STEPS} steps: {n_it} iterations, history "
          f"{[f'{v:.4e}' for v in hist.tolist()]} (chunked residual {want:.6e}); alphas "
          f"{[f'{v:.6f}' for v in alphas[:n_it].tolist()]}, betas "
          f"{[f'{v:.6f}' for v in betas[:n_it].tolist()]}")


def _hierarchy_persistence(syss, hs, dev, card):
    """``save_pytree`` then ``load_pytree`` of the 127^3 smooth Galerkin
    hierarchy: the loaded one's MGCG takes the same count and the same x
    bit for bit."""
    b = torch.from_numpy(syss.b.astype(np.float32)).to(dev).reshape(SMOOTH_GRID)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    solve = lambda h: cg_solve(h.levels[0].A, b, policy=pol, M=as_preconditioner(h), precise_dot=True)
    ref = solve(hs)
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "hierarchy.npz")
        t0 = time.perf_counter()
        save_pytree(f, hs)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        h2 = load_pytree(f, device=dev)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        mb = os.path.getsize(f) / 1e6
    got = solve(h2)
    _require(ref.converged and got.iterations == ref.iterations and torch.equal(got.x, ref.x),
             f"hierarchy persistence: {got.iterations} iterations against {ref.iterations}, x "
             f"bit-identical {bool(torch.equal(got.x, ref.x))}")
    print(f"hierarchy persistence smooth {SMOOTH_GRID}: file {mb:.1f} MB, save {save_s:.3f} s, load "
          f"{load_s:.3f} s against the host setup's {sum(hs.setup_s.values()):.3f} s; MGCG "
          f"{got.iterations} iterations, x bit-identical [{card}]")


def _reference_workloads_twin():
    """The twin of ``examples/reference_workloads.py`` at ``--quick`` in
    fp64 on the card: every row must be OK."""
    with tempfile.TemporaryDirectory() as d:
        f = os.path.join(d, "rows.json")
        rc = reference_workloads.main(["--quick", "--json", f])
        with open(f) as fh:
            rows = json.load(fh)["rows"]
    _require(rc == 0 and all(r["ok"] for r in rows), f"reference_workloads --quick: rc {rc}")
    simple = next(r for r in rows if r["workload"] == "simple_cuda")
    print(f"reference_workloads --quick: {len(rows)} rows OK; simple_cuda as measured: "
          f"{json.dumps(simple)}")


def _drivers(paths, syss, hs, dev, card, count):
    """The drivers phase over ``paths`` (``_driver_paths``)."""
    refs = [_drivers_path(p, dev, card, count) for p in paths]
    _resume_path(paths[1], refs[1], card)
    _traced_path(paths[0], refs[0])
    _hierarchy_persistence(syss, hs, dev, card)
    _reference_workloads_twin()


# ---------------------------------------------------------------------------
# the nonsymmetric and indefinite Krylov family
# ---------------------------------------------------------------------------

#: convection-diffusion at full width: 1023^2 upwind, recirculating, eps
#: 0.05 (cell Peclet 20), fp32 rel_l2 < TOL; plain BiCGStab capped and not
#: required to converge (the JAX package's TPU run stopped unconverged at
#: 682), Jacobi-GMRES(32) capped (it stalled past 20,000 steps at 255^2 in
#: fp32 on the CPU; at 1023^2 it took 153 on the card)
NONSYM_GRID = (1023, 1023)
NONSYM_EPS = 0.05
NONSYM_BICGSTAB_CAP = 2000
NONSYM_GMRES_CAP = 3000
NONSYM_RESTART = 32
NONSYM_INNER = 8
#: IDR(4) through method="auto": the calibration case of _auto_method
#: (fp32's attainable accuracy there is about 2.2e-6: the port's IDR accepts
#: convergence only on a replaced residual, see solvers/idr.py), cut from
#: 255^2 (17,490 matvecs, 36-52 s of the run) to 127^2 to keep the run
#: inside its time limit
IDR_GRID = (127, 127)
IDR_EPS = 0.5
IDR_TOL = 2e-6
IDR_S = 4
#: the matvecs of the IDR run whose wall is the warm wall and whose trace
#: gives the busy share
IDR_WINDOW = 1000
#: IDR's true residual against the one it reports: the drift that residual
#: replacement bounds read 7000x in the JAX package's fp32 run without it
IDR_DRIFT = 10.0
#: amg_bicgstab on a bare CSR; the flagship's nonsymmetric twin
AMG_NONSYM_GRID = (511, 511)
TWIN_N, TWIN_BAND = 207402, 160
#: Helmholtz 255^2 at 1.5 lambda_1, in fp64: fp32 MINRES stops at a true
#: 2e-5 there (its recurrence passes 1e-6 first; measured on the CPU)
HELM_GRID = (255, 255)
HELM_SHIFT = 1.5
#: fp64 card against CPU at about 63^2: x within this fraction of ||x||
KRYLOV_AGREE = 1e-9
#: warm calls timed for a median wall (after one discarded)
WALL_REPS = 5


def _lam1(grid) -> float:
    """The smallest eigenvalue of the Dirichlet Laplacian on ``grid``."""
    return sum(2.0 - 2.0 * np.cos(np.pi / (g + 1)) for g in grid)


def _wall_ms(fn) -> float:
    """Host-clock ms of one call of ``fn`` that ends in a synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def _wall_median_ms(fn, reps=WALL_REPS):
    """(median, min, max) host-clock ms of ``reps`` calls of ``fn`` after
    one discarded call: one warm call's wall moves by 2x with the host."""
    fn()
    walls = sorted(_wall_ms(fn) for _ in range(reps))
    return walls[reps // 2], walls[0], walls[-1]


def _fmt_wall(w, reps=WALL_REPS) -> str:
    return f"{w[0]:.3f} ms (median of {reps}, {w[1]:.3f}-{w[2]:.3f})"


def _stencil_counts(got) -> dict:
    """The record's counts of a route: #4 and each stencil kernel."""
    return {k: got[k] for k in ("spmv_dia", "spmv_stencil", "spmv_stencil_wide",
                                "spmv_const_stencil")}


def _nonsym_route(tag, A, b, dev, card, want4, warm, true_of, require=True, window=None,
                  median=False, **kw):
    """One counted ``api.solve`` on the card in fp32: launches from a reset,
    kernel #4's count against ``want4(result)``, the true fp64 relative
    residual (``true_of(x)``) within TRUE_REL where it converged (and
    convergence, with ``require``), the warm wall of ``warm`` (one call, or
    with ``median`` the median of WALL_REPS) and the device busy share of
    ``warm``, or of ``window`` (a shorter run of the same loop: a long
    solve's trace takes minutes to read).  Returns (result, launches, warm
    ms)."""
    _reset_counts()
    t0 = time.perf_counter()
    res = api.solve(A, b, dtype=np.float32, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _amg_launches()
    got.update(spmv_stencil=spmv_stencil_cuda.launches,
               spmv_stencil_wide=spmv_stencil_wide_cuda.launches,
               spmv_const_stencil=spmv_const_stencil_cuda.launches)
    x = res.x.cpu().numpy()
    rel = true_of(x)
    conv = bool(res.converged)
    if require:
        _require(conv, f"{tag}: did not converge in {res.iterations} iterations")
    if conv:
        _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    want = want4(res)
    _require(got["spmv_dia"] == want, f"{tag}: {got['spmv_dia']} spmv_dia launches, the route "
             f"implies {want}")
    if median:
        walls = _wall_median_ms(warm)
        warm_ms, warm_txt = walls[0], _fmt_wall(walls)
    else:
        warm_ms = _wall_ms(warm)
        warm_txt = f"{warm_ms:.3f} ms"
    print(f"{tag}: {res.iterations} iterations, converged {conv}, recurrence residual "
          f"{float(res.residual):.3e}, true fp64 rel residual {rel:.3e}, spmv_dia launches "
          f"{got['spmv_dia']} (= the recurrence's {want}), #3 by grid {got['var_by_grid']}, #1 by "
          f"grid {got['const_by_grid']}; wall {wall:.3f} s with the setup, warm wall "
          f"{warm_txt} [{card}]")
    if window is None:
        _device_time_top(warm, warm_ms, card, top=4)
    else:
        _device_time_top(window, _wall_ms(window), card, top=4)
    return res, got, warm_ms


def _convection_1023(dev, card, count):
    """Convection-diffusion NONSYM_GRID at NONSYM_EPS: mg_bicgstab (the
    rediscretized hierarchy, #3 at every level), Jacobi-GMRES(32),
    mg_fgmres with inner BiCGStab, plain BiCGStab; each on #4 exactly as its
    recurrence implies."""
    from conjugategradient_tpu_torch.precond import multigrid
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu_torch.solvers.gmres import (
        fgmres_solve,
        gmres_solve,
        inner_solve_preconditioner,
    )

    g = NONSYM_GRID
    t0 = time.perf_counter()
    s = generators.convection_diffusion_system(g, eps=NONSYM_EPS)
    co = generators.convection_diffusion_coarse_operator(NONSYM_EPS)
    print(f"convection-diffusion {g} eps {NONSYM_EPS}: n {s.n}, generated in "
          f"{time.perf_counter() - t0:.3f} s")
    A32 = s.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    true_of = lambda x: _host_rel_residual(s.A, s.b, x)
    pol = lambda cap=None: ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=cap)
    tag = f"convection {g} mg_bicgstab"
    with _facade_built(multigrid, "build_hierarchy") as built:
        res, got, _ = _nonsym_route(
            tag, s.A, s.b, dev, card, lambda r: 2 * r.iterations + 1,
            lambda: bicgstab_solve(A32, b32, policy=pol(), M=multigrid.as_preconditioner(built[0])),
            true_of, method="mg_bicgstab", grid=g, coarse_operator=co, tol=TOL, norm="rel_l2")
    h = built[0]
    _require_level_launches(tag, h, got)
    _require(all(isinstance(l.A, StencilMatrix) for l in h.levels),
             f"{tag}: levels {[type(l.A).__name__ for l in h.levels]} are not all kernel #3's")
    print(f"{tag}: levels {[l.grid for l in h.levels]} + dense {h.coarse_inv.shape[0]}, host "
          f"setup s { {k: round(v, 3) for k, v in h.setup_s.items()} }")
    count(f"nonsymmetric: {tag}", _stencil_counts(got))
    its = {"mg_bicgstab": res.iterations}

    inv = torch.from_numpy((1.0 / s.A.data[s.A.offsets.index(0)]).astype(np.float32)).to(dev)
    tag = f"convection {g} jacobi_gmres restart {NONSYM_RESTART}"
    res, got, _ = _nonsym_route(
        tag, s.A, s.b, dev, card,
        lambda r: 1 + r.iterations + 2 * r.cycles,
        lambda: gmres_solve(A32, b32, policy=pol(NONSYM_GMRES_CAP), M=lambda r: inv * r,
                            restart=NONSYM_RESTART),
        true_of, method="jacobi_gmres", restart=NONSYM_RESTART, tol=TOL,
        norm="rel_l2", max_iteration=NONSYM_GMRES_CAP)
    count(f"nonsymmetric: {tag}", {"spmv_dia": got["spmv_dia"]})
    its["jacobi_gmres"] = (res.iterations, bool(res.converged))

    tag = f"convection {g} mg_fgmres inner bicgstab"
    with _facade_built(multigrid, "build_hierarchy") as built:
        res, got, _ = _nonsym_route(
            tag, s.A, s.b, dev, card,
            lambda r: 1 + 2 * r.cycles + r.iterations * (2 + 2 * NONSYM_INNER),
            lambda: fgmres_solve(A32, b32, policy=pol(), M=inner_solve_preconditioner(
                A32, "bicgstab", NONSYM_INNER, M=multigrid.as_preconditioner(built[0]))),
            true_of, method="mg_fgmres", inner="bicgstab", grid=g, coarse_operator=co, tol=TOL,
            norm="rel_l2")
    _require_level_launches(tag, built[0], got)
    count(f"nonsymmetric: {tag}", _stencil_counts(got))
    its["mg_fgmres"] = res.iterations

    tag = f"convection {g} bicgstab (capped at {NONSYM_BICGSTAB_CAP})"
    res, got, _ = _nonsym_route(
        tag, s.A, s.b, dev, card, lambda r: 2 * r.iterations + 1,
        lambda: bicgstab_solve(A32, b32, policy=pol(NONSYM_BICGSTAB_CAP)), true_of,
        require=False, method="bicgstab", tol=TOL, norm="rel_l2",
        max_iteration=NONSYM_BICGSTAB_CAP)
    count(f"nonsymmetric: {tag}", {"spmv_dia": got["spmv_dia"]})
    its["bicgstab"] = (res.iterations, bool(res.converged))
    print(f"convection {g}: iterations by route {its} [{card}]")


def _idr_auto(dev, card, count):
    """IDR(4) through method="auto" on IDR_GRID convection at IDR_EPS, no
    grid: auto must choose idr, #4 run exactly once per matvec, per
    replacement and for the initial residual, and the recurrence residual
    must agree with the true one."""
    from conjugategradient_tpu_torch.solvers.idr import idr_solve

    s = generators.convection_diffusion_system(IDR_GRID, eps=IDR_EPS)
    t0 = time.perf_counter()
    chose = api._auto_method(s.A, None, dev)
    probe_s = time.perf_counter() - t0
    _require(chose == "idr", f"auto on convection {IDR_GRID} chose {chose!r}, not 'idr'")
    A32 = s.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    tag = f"convection {IDR_GRID} eps {IDR_EPS} auto -> idr"
    # the warm wall and the busy share of the first IDR_WINDOW matvecs: a
    # warm re-run of the whole solve (17,490 matvecs) took 22.5 s; its
    # wall with the setup below is the whole solve's
    res, got, _ = _nonsym_route(
        tag, s.A, s.b, dev, card,
        lambda r: 1 + r.iterations + r.replacements,
        lambda: idr_solve(A32, b32, policy=ConvergencePolicy(
            tol=IDR_TOL, norm="rel_l2", max_iteration=IDR_WINDOW)),
        lambda x: _host_rel_residual(s.A, s.b, x), method="auto", tol=IDR_TOL, norm="rel_l2")
    true = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
    drift = true / float(res.residual)
    _require(drift <= IDR_DRIFT, f"{tag}: true residual {true:.3e} is {drift:.1f}x the "
             f"recurrence's {float(res.residual):.3e}")
    print(f"{tag}: auto's host probe {probe_s:.3f} s; the warm wall above is of the first "
          f"{IDR_WINDOW} matvecs; {res.iterations} matvecs "
          f"({res.iterations // (IDR_S + 1)} cycles, {res.replacements} replacements), true / "
          f"reported residual {drift:.3f}")
    count(f"nonsymmetric: {tag}", {"spmv_dia": got["spmv_dia"]})


def _amg_bicgstab_csr(dev, card, count):
    """amg_bicgstab on AMG_NONSYM_GRID convection as a bare CSR (the grid
    inferred, the unsmoothed prolongator's cube levels on #3 or #1), the
    outer products on cuSPARSE (no #4)."""
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

    s = generators.convection_diffusion_system(AMG_NONSYM_GRID, eps=NONSYM_EPS)
    A = from_scipy(to_scipy(s.A))
    tag = f"convection {AMG_NONSYM_GRID} CSR amg_bicgstab"
    A32 = A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    with _facade_amg() as built:
        res, got, _ = _nonsym_route(
            tag, A, s.b, dev, card, lambda r: _cycle_dia_launches(built[0]) * 2 * r.iterations,
            lambda: bicgstab_solve(A32, b32, policy=ConvergencePolicy(tol=TOL, norm="rel_l2"),
                                   M=amg.amg_preconditioner(built[0])),
            lambda x: _host_rel_residual(s.A, s.b, x), method="amg_bicgstab", tol=TOL,
            norm="rel_l2")
    h = built[0]
    _require(h.smoother == "jacobi" and all(l.sa_c == 0.0 for l in h.levels),
             f"{tag}: smoother {h.smoother}, sa_c {[l.sa_c for l in h.levels]}: not the "
             "unsmoothed Jacobi hierarchy of a nonsymmetric A")
    _require_level_launches(tag, h, got)
    print(f"{tag}: levels {_amg_levels(h)} + dense {h.coarse_inv.shape[0]}, host setup s "
          f"{ {k: round(v, 3) for k, v in h.setup_s.items()} }")
    count(f"nonsymmetric: {tag}", _stencil_counts(got))


def _flagship_twin(dev, card, count):
    """The flagship's nonsymmetric twin: BiCGStab on #4, an n x MULTI_K
    block through bicgstab_solve_multi on #5 (column 0 the single-RHS
    count), refined_solve(inner="bicgstab") to an absolute fp64
    ||r||_2 < FLAGSHIP_TOL."""
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu_torch.solvers.multi import bicgstab_solve_multi
    from conjugategradient_tpu_torch.solvers.refine import refined_solve

    t0 = time.perf_counter()
    s = generators.nonsymmetric_banded_system(TWIN_N, TWIN_BAND)
    print(f"nonsymmetric twin n {TWIN_N} band {TWIN_BAND}: built in "
          f"{time.perf_counter() - t0:.3f} s")
    A32 = s.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    true_of = lambda x: _host_rel_residual(s.A, s.b, x)
    tag = "nonsymmetric twin bicgstab"
    res, got, _ = _nonsym_route(tag, s.A, s.b, dev, card, lambda r: 2 * r.iterations + 1,
                                lambda: bicgstab_solve(A32, b32, policy=pol), true_of,
                                method="bicgstab", tol=TOL, norm="rel_l2")
    count(f"nonsymmetric: {tag}", {"spmv_dia": got["spmv_dia"]})

    rng = np.random.default_rng(SEED + 14)
    B = np.column_stack([s.b] + [rng.standard_normal(s.n) for _ in range(MULTI_K - 1)])
    B32 = torch.from_numpy(B.astype(np.float32)).to(dev)
    tag = f"nonsymmetric twin bicgstab n x {MULTI_K}"
    _reset_counts()
    resB = api.solve(s.A, B, method="bicgstab", tol=TOL, norm="rel_l2", dtype=np.float32,
                     device=dev)
    torch.cuda.synchronize()
    n4, n5 = spmv_dia_cuda.launches, spmm_dia_cuda.launches
    cols = resB.iterations.cpu().tolist()
    want = (2 * max(cols) + 1) * len(k_chunks(MULTI_K)) * len(dia_groups(s.A.ndiags))
    _require(bool(resB.converged.all()), f"{tag}: converged {resB.converged.tolist()}")
    _require(cols[0] == res.iterations, f"{tag}: column 0 took {cols[0]} iterations, the "
             f"single-RHS solve {res.iterations}")
    _require(n5 == want and n4 == 0, f"{tag}: spmm_dia {n5} (the recurrence implies {want}), "
             f"spmv_dia {n4}")
    X = resB.x.cpu().numpy()
    rels = [_host_rel_residual(s.A, B[:, j], X[:, j]) for j in range(MULTI_K)]
    _require(max(rels) <= TRUE_REL, f"{tag}: true fp64 relative residuals {rels}")
    warm = lambda: bicgstab_solve_multi(A32, B32, policy=pol)
    warm_ms = _wall_ms(warm)
    print(f"{tag}: iterations by column {cols}, spmm_dia launches {n5} (= {want}), true fp64 "
          f"rel residuals {[float(f'{r:.3e}') for r in rels]}, warm wall {warm_ms:.3f} ms "
          f"[{card}]")
    _device_time_top(warm, warm_ms, card, top=4)
    count(f"nonsymmetric: {tag}", {"spmm_dia": n5})

    tag = "nonsymmetric twin refined_solve(inner='bicgstab')"
    _reset_counts()
    t0 = time.perf_counter()
    rf = refined_solve(s.A, s.b, tol=FLAGSHIP_TOL, inner="bicgstab", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n4 = spmv_dia_cuda.launches
    r_abs = float(np.linalg.norm(s.b - oracle.spmv(s.A, rf.x)))
    _require(rf.converged and r_abs < FLAGSHIP_TOL,
             f"{tag}: converged {rf.converged}, true fp64 ||r||_2 {r_abs:.3e}")
    want = 2 * rf.inner_iterations + rf.outer_iterations
    _require(n4 == want, f"{tag}: {n4} spmv_dia launches, the passes imply {want}")
    print(f"{tag}: {rf.outer_iterations} outer passes, {rf.inner_iterations} inner iterations, "
          f"true fp64 ||r||_2 {r_abs:.3e}, spmv_dia launches {n4} (= {want}), wall {wall:.3f} s "
          f"(inner {rf.timings['inner_s']:.3f} s) [{card}]")
    count(f"nonsymmetric: {tag}", {"spmv_dia": n4})


def _helmholtz(dev, card, count):
    """Helmholtz HELM_GRID at HELM_SHIFT lambda_1 through method="auto",
    which must choose minres (the second Lanczos stage of the port's probe
    on the card), in fp64: the probe's #4 launches (none where its host
    stage decides) and then #4 once per iteration and twice more.  (The
    probe's separate run and the warm solve's profile were cut to make room
    for the multi-process phase.)"""
    from conjugategradient_tpu_torch.solvers.minres import minres_solve

    g = HELM_GRID
    s = generators.helmholtz_system(g, HELM_SHIFT * _lam1(g))
    stage2 = 4 * int(np.ceil(np.sqrt(s.n)))
    tag = f"Helmholtz {g} shift {HELM_SHIFT} lambda_1 auto -> minres (fp64)"
    A64 = s.A.device_put(torch.float64, dev)
    b64 = torch.from_numpy(s.b).to(dev)
    chose, auto = [], api._auto_method
    api._auto_method = lambda *a, **k: chose.append(auto(*a, **k)) or chose[-1]  # what it picks
    _reset_counts()
    t0 = time.perf_counter()
    try:
        res = api.solve(s.A, s.b, method="auto", tol=TOL, norm="rel_l2", device=dev)
    finally:
        api._auto_method = auto
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    n4 = spmv_dia_cuda.launches
    _require(chose == ["minres"], f"auto on Helmholtz {g} chose {chose}, not 'minres'")
    rel = _host_rel_residual(s.A, s.b, res.x.cpu().numpy())
    _require(res.converged and rel <= TRUE_REL,
             f"{tag}: converged {res.converged} in {res.iterations}, true rel {rel:.3e}")
    # the probe, then MINRES: a product an iteration and two more
    probe = n4 - (res.iterations + 2)
    _require(probe in (0, stage2), f"{tag}: {n4} spmv_dia launches, MINRES's {res.iterations + 2}"
             f" and a probe of {probe}: neither 0 (the host stage decided) nor the card stage's "
             f"{stage2}")
    warm = lambda: minres_solve(A64, b64, policy=ConvergencePolicy(tol=TOL, norm="rel_l2"))
    warm_ms = _wall_ms(warm)
    print(f"{tag}: {res.iterations} iterations, true fp64 rel residual {rel:.3e}, spmv_dia "
          f"launches {n4} (= {probe} probe ({'the card stage' if probe else 'the host stage'} "
          f"decided) + {res.iterations + 2}), facade {solve_s:.3f} s with the probe, warm wall "
          f"{warm_ms:.3f} ms [{card}]")
    count(f"nonsymmetric: {tag}", {"spmv_dia": n4}, fp32=False)


#: route -> (system, api.solve keywords) of the fp64 card-against-CPU
#: checks at about 63^2 (unpreconditioned BiCGStab, IDR and GMRES on the
#: band: their counts on convection at 63^2 move under a one-ulp change of
#: b, GMRES(32)'s 1459 by one between the card and the CPU)
KRYLOV_SMALL = {
    "bicgstab band": ("band", dict(method="bicgstab")),
    "gmres band restart 8": ("band", dict(method="gmres", restart=8)),
    "fgmres inner bicgstab band": ("band", dict(method="fgmres", inner="bicgstab")),
    "minres Helmholtz": ("helmholtz", dict(method="minres")),
    "idr band": ("band", dict(method="idr")),
    "chebyshev Poisson": ("poisson", dict(method="chebyshev")),
    "mg_bicgstab convection": ("cd", dict(method="mg_bicgstab", grid=(63, 63))),
    "amg_bicgstab convection": ("cd", dict(method="amg_bicgstab")),
    "bicgstab band n x 3": ("band", dict(method="bicgstab")),
    "refined inner bicgstab band": ("band", dict(method="refined", inner="bicgstab",
                                                 device_dtype=np.float64)),
}


def _krylov_small_system(kind):
    g = (63, 63)
    if kind == "band":
        return generators.nonsymmetric_banded_system(63 * 63, 16)
    if kind == "cd":
        return generators.convection_diffusion_system(g, eps=1.0)
    if kind == "helmholtz":
        return generators.helmholtz_system(g, HELM_SHIFT * _lam1(g))
    return generators.poisson_system(g)


def _card_vs_cpu(dev, card, label, routes, system_of, agree, extra_of=None):
    """Each route of ``routes`` (route -> (system kind, api.solve keywords))
    in fp64 on the card and on the CPU, on ``system_of(kind) -> (A, b)``
    (an ``"n x"`` route on b and two seeded columns): equal counts, x
    within ``agree`` of ||x||.  ``extra_of(route, A) -> (cpu keywords, card
    keywords)`` adds per-device arguments."""
    host = lambda v: v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    out = {}
    for route, (kind, kw) in routes.items():
        A, b = system_of(kind)
        if "n x" in route:
            b = np.column_stack([b] + [np.random.default_rng(j).standard_normal(b.size)
                                       for j in (1, 2)])
        refined = kw["method"] == "refined"
        opts = dict(tol=FLAGSHIP_TOL if refined else 1e-10, norm="l2" if refined else "rel_l2",
                    **kw)
        cpu_kw, card_kw = extra_of(route, A) if extra_of else ({}, {})
        rc = api.solve(A, b, device="cpu", **opts, **cpu_kw)
        rg = api.solve(A, b, device=dev, **opts, **card_kw)
        if refined:
            its_c, its_g = (rc.outer_iterations, rc.inner_iterations), (rg.outer_iterations,
                                                                        rg.inner_iterations)
        else:
            its_c, its_g = host(rc.iterations).tolist(), host(rg.iterations).tolist()
        xc, xg = host(rc.x), host(rg.x)
        dx = float(np.linalg.norm(xg - xc) / np.linalg.norm(xc))
        _require(bool(np.all(host(rg.converged))) and bool(np.all(host(rc.converged))),
                 f"card vs CPU {route}: converged {host(rg.converged)} / {host(rc.converged)}")
        _require(its_g == its_c and dx <= agree,
                 f"card vs CPU {route}: {its_g} / {its_c} iterations, x differs by {dx:.3e}")
        out[route] = (its_g, float(f"{dx:.2e}"))
    print(f"{label}, card against CPU (iterations, max rel x diff): {out} [{card}]")
    return out


def _nonsymmetric(dev, card, count):
    """The nonsymmetric and indefinite Krylov family on the card."""
    for step in (_convection_1023, _idr_auto, _amg_bicgstab_csr, _flagship_twin, _helmholtz):
        t0 = time.perf_counter()
        step(dev, card, count)
        print(f"  {step.__name__.lstrip('_')}: {time.perf_counter() - t0:.1f} s")
    _card_vs_cpu(dev, card, "Krylov family fp64 at 63^2", KRYLOV_SMALL,
                 lambda kind: (lambda s: (s.A, s.b))(_krylov_small_system(kind)), KRYLOV_AGREE)


# ---------------------------------------------------------------------------
# least squares, s-step, deflation, adjoints
# ---------------------------------------------------------------------------

#: the sparse regression of the rectangular LSMR: LSQ_M x LSQ_N, LSQ_NNZ
#: seeded entries a row plus the identity on the first LSQ_N rows
#: (tests/test_lsmr.py::_overdetermined's construction at a user's size;
#: cut from 1,048,576 x 262,144, whose host build and two scipy solves took
#: most of a 52.5-s step, to keep the run inside its time limit)
LSQ_M, LSQ_N, LSQ_NNZ = 524_288, 131_072, 16
LSQ_DAMP = 0.5
#: the true ||A^T r|| / ||A^T b|| (damped: ||A^T r - damp^2 x||) every LSMR
#: run must meet on the host in fp64
LSQ_NORMAL_REL = 1e-5
#: x against scipy's: ||x - x_s|| / ||x_s|| <= margin * kappa(A^T A + damp^2)
#: * (rho + rho_s), rho the two true normal residuals above.  This follows
#: from A^T r = (A^T A + damp^2)(x* - x): each error is at most kappa rho
#: ||x*||.  kappa from LSQ_LANCZOS plain fp64 Lanczos steps on A^T A on the
#: card; its Ritz values lie inside the spectrum, so the margin covers the
#: underestimate (12.3 at a 1/16-scale copy on the host, Lanczos and eigsh)
LSQ_LANCZOS, LSQ_KAPPA_MARGIN = 64, 2.0
LSQ_SCIPY_TOL = 1e-10
CACG_S = 4
CACG_GRID = (1023, 1023)
#: CA-CG's cap on the Poisson DIA, in multiples of cg's count there (fp32
#: s = 4 diverges at 255^2 in both packages on the CPU)
CACG_CAP = 2
#: a CA-CG run's true residual within this factor of the one it reports
CACG_HONEST = 10.0
#: the deflation workload: the flagship's generator with four weakly
#: coupled unknowns (generators.outlier_system)
OUTLIER_BAND, OUTLIERS, OUTLIER_SCALE = 160, 4, 1e-3
DEFL_K = 8
#: right-hand sides of the solve sequence reusing one deflation
DEFL_SEQ = 5
#: plain CG's budget on the outlier system (64 iterations in fp32 on the CPU)
PLAIN_CAP = 5000
#: the implicit gradients against central differences: entries and bound
#: (1e-8 measured on the host at the flagship; steps: 1 in b, where the
#: loss is linear, and 1e-2 in an entry of data, with its mirror where A is
#: symmetric); 2 entries of each, cut from 4 to make room for the
#: multi-process phase
FD_ENTRIES, FD_REL, FD_STEP_B, FD_STEP_DATA = 2, 1e-5, 1.0, 1e-2
IMPLICIT_TOL = 1e-13
#: the precision helpers' length, the multiple of log2(n) eps^2 their
#: double-float tree may lose, and their error on the cancelling input
#: against the plain fp32 reduction's
PREC_N = 16_777_216
PREC_TREE, PREC_GAIN = 4.0, 1e-2
#: fp64 card against CPU of the new routes: x within this fraction of ||x||
LSQ_AGREE = 1e-9


def _normal_rel(A, At, b, x, damp=0.0) -> float:
    """||A^T (b - A x) - damp^2 x|| / ||A^T b|| in fp64 on the host."""
    r = b - oracle.spmv(A, x)
    return float(np.linalg.norm(oracle.spmv(At, r) - damp * damp * x)
                 / np.linalg.norm(oracle.spmv(At, b)))


def _transposed_dia(dev, card, count):
    """The flagship's nonsymmetric twin and its host transpose on #4: A^T x
    against its twin and cuSPARSE's product of the transpose's CSR, timed
    beside A x; then CGNR and LSMR through api.solve in fp32, #4 twice an
    iteration plus the setup products."""
    from conjugategradient_tpu_torch.core.formats import transpose
    from conjugategradient_tpu_torch.ops.spmv import csr_tensor
    from conjugategradient_tpu_torch.solvers.cg import cg_solve as _cg
    from conjugategradient_tpu_torch.solvers.cgnr import normal_operators
    from conjugategradient_tpu_torch.solvers.lsmr import lsmr_loop

    t0 = time.perf_counter()
    s = generators.nonsymmetric_banded_system(TWIN_N, TWIN_BAND)
    At = transpose(s.A)
    print(f"nonsymmetric twin n {TWIN_N} band {TWIN_BAND} and its host transpose in "
          f"{time.perf_counter() - t0:.3f} s ({At.ndiags} diagonals, offsets {At.offsets[0]}.."
          f"{At.offsets[-1]})")
    A32, At32 = s.A.device_put(torch.float32, dev), At.device_put(torch.float32, dev)
    x = torch.randn(s.n, generator=torch.Generator(device=dev).manual_seed(SEED + 15), device=dev)
    y = spmv_dia_cuda(At32, x)
    err, scale = _max_err(y, spmv_dia_ref(At32, x))
    _require(err <= KERNEL_REL * scale, f"spmv_dia A^T: max err {err:.3e} vs the twin")
    csr = csr_tensor(dia_to_csr(At).device_put(torch.float32, dev))
    lib_ms = _library("spmv_dia A^T band 160 fp32 (the transpose's CSR)", lambda: csr @ x, y,
                      card, 200)
    t_ms = time_ms(lambda: spmv_dia_cuda(At32, x), 200)
    a_ms = time_ms(lambda: spmv_dia_cuda(A32, x), 200)
    p_ms = time_ms(lambda: spmv_dia_ref(At32, x), 10)
    bound = bound_ms(spmm_bytes(At32, 1), 2 * dia_nnz(At32))
    rec = dict(ms=t_ms, a_ms=a_ms, plain_ms=p_ms, library_ms=lib_ms, bound_ms=bound[0],
               bound_by=bound[1], max_abs_err=err)
    print(f"time spmv_dia A^T fp32 n={s.n}: kernel {t_ms:.4f} ms beside A x {a_ms:.4f} ms (bound "
          f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / t_ms:.1%} of it), twin {p_ms:.4f} ms, "
          f"cuSPARSE {lib_ms:.4f} ms; max err vs twin {err:.3e} [{card}]")
    del csr

    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    op, opT = normal_operators(s.A, b32)
    for method, want4, warm in (
            ("cgnr", lambda r: 2 * r.iterations + 5, lambda: _cg(lambda v: opT(op(v)), opT(b32),
                                                                  policy=pol)),
            ("lsmr", lambda r: 2 * r.iterations + 3, lambda: lsmr_loop(op, opT, b32, pol))):
        tag = f"nonsymmetric twin {method}"
        res, got, _ = _nonsym_route(tag, s.A, s.b, dev, card, want4, warm,
                                    lambda x: _host_rel_residual(s.A, s.b, x), median=True,
                                    method=method, tol=TOL, norm="rel_l2")
        n4 = got["spmv_dia"]
        xh = res.x.cpu().numpy().astype(np.float64)
        rel, nrel = _host_rel_residual(s.A, s.b, xh), _normal_rel(s.A, At, s.b, xh)
        _require(rel <= TRUE_REL and nrel <= TRUE_REL,
                 f"{tag}: true fp64 ||r||/||b|| {rel:.3e}, ||A^T r||/||A^T b|| {nrel:.3e}")
        print(f"{tag}: true fp64 ||b - A x||/||b|| {rel:.3e}, ||A^T r||/||A^T b|| {nrel:.3e} "
              f"(BiCGStab: 5 iterations in PR 14) [{card}]")
        count(f"least squares: {tag}", {"spmv_dia": n4})
    return rec


def _regression(m, n, nnz, seed):
    """The seeded sparse regression (scipy CSR) and its b."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(m, dtype=np.int64), nnz)
    cols = rng.integers(0, n, m * nnz)
    vals = rng.standard_normal(m * nnz)
    S = (sp.csr_matrix((vals, (rows, cols)), shape=(m, n)) + sp.eye(m, n, format="csr")).tocsr()
    return S, rng.standard_normal(m)


def _rectangular_lsmr(dev, card, count):
    """LSMR on the LSQ_M x LSQ_N regression through method="auto" (which
    must route to lsmr) and with damp=LSQ_DAMP, both on cuSPARSE's product
    (no #4), against scipy's lsmr on the host CSR."""
    import scipy.sparse.linalg as sla

    from conjugategradient_tpu_torch.core.formats import transpose
    from conjugategradient_tpu_torch.ops.spmv import spmv
    from conjugategradient_tpu_torch.solvers import lsmr as lsmr_mod

    t0 = time.perf_counter()
    S, b = _regression(LSQ_M, LSQ_N, LSQ_NNZ, SEED)
    A = from_scipy(S)
    At = transpose(A)
    print(f"regression {LSQ_M} x {LSQ_N}: {A.nnz} nonzeros, built with its host transpose in "
          f"{time.perf_counter() - t0:.3f} s")
    A64, At64 = A.device_put(torch.float64, dev), At.device_put(torch.float64, dev)
    lo, hi = eigen.lanczos_ritz_bounds(lambda v: spmv(At64, spmv(A64, v)), LSQ_N, LSQ_LANCZOS,
                                       device=dev)
    del A64, At64
    b32 = torch.from_numpy(b.astype(np.float32)).to(dev)
    for damp in (0.0, LSQ_DAMP):
        tag = f"regression lsmr {'auto' if damp == 0 else f'damp {damp}'}"
        kw = dict(method="auto", tol=TOL, norm="rel_l2")
        if damp:
            kw["damp"] = damp
        with _facade_built(lsmr_mod, "lsmr_solve") as called:
            _reset_counts()
            t0 = time.perf_counter()
            res = api.solve(A, b, dtype=np.float32, device=dev, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        n4 = spmv_dia_cuda.launches
        _require(len(called) == 1 and n4 == 0,
                 f"{tag}: lsmr called {len(called)} times, {n4} spmv_dia launches")
        _require(res.converged, f"{tag}: did not converge in {res.iterations} iterations")
        x = res.x.cpu().numpy().astype(np.float64)
        rho = _normal_rel(A, At, b, x, damp)
        t0 = time.perf_counter()
        xs = sla.lsmr(S, b, damp=damp, atol=LSQ_SCIPY_TOL, btol=LSQ_SCIPY_TOL)[0]
        scipy_s = time.perf_counter() - t0
        rho_s = _normal_rel(A, At, b, xs, damp)
        kappa = (hi + damp * damp) / (lo + damp * damp)
        dx = float(np.linalg.norm(x - xs) / np.linalg.norm(xs))
        bound = LSQ_KAPPA_MARGIN * kappa * (rho + rho_s)
        _require(rho <= LSQ_NORMAL_REL, f"{tag}: true normal residual {rho:.3e}")
        _require(dx <= bound, f"{tag}: x differs from scipy's by {dx:.3e} > {bound:.3e}")
        Ad, Atd = A.device_put(torch.float32, dev), At.device_put(torch.float32, dev)
        warm = lambda: lsmr_mod.lsmr_loop(lambda v: spmv(Ad, v), lambda v: spmv(Atd, v), b32,
                                          ConvergencePolicy(tol=TOL, norm="rel_l2"), damp=damp,
                                          n_iter_scale=LSQ_M)
        walls = _wall_median_ms(warm)
        warm_ms = walls[0]
        print(f"{tag}: routed to lsmr, {res.iterations} iterations, reported {float(res.residual):.3e}"
              f", true fp64 normal residual {rho:.3e} (scipy's {rho_s:.3e} in {scipy_s:.1f} s on the"
              f" host), x vs scipy {dx:.3e} <= {bound:.3e} (kappa(A^T A + damp^2) {kappa:.2f} by "
              f"Lanczos); wall {wall:.3f} s with the host transpose, warm loop {_fmt_wall(walls)} "
              f"[{card}]")
        _device_time_top(warm, warm_ms, card, top=4)
        del Ad, Atd


def _cacg_route(tag, A, b, dev, card, count, true_of, cg_its, require=True, **kw):
    """One counted CA-CG run through api.solve in fp32: outer steps and host
    reads counted at the loop's injection points, #4 exactly 1 + 2s per
    outer step, the true residual against the reported one."""
    from conjugategradient_tpu_torch.solvers import cacg

    outer, reads, loop = [], [], cacg.cacg_loop

    def counted(op, b_, x0, policy, s, dot, gram, **kw_):
        def gram_c(V):
            outer.append(1)
            return gram(V)

        def dot_c(u, v):
            reads.append(1)
            return dot(u, v)

        return loop(op, b_, x0, policy, s, dot_c, gram_c, **kw_)

    cacg.cacg_loop = counted
    try:
        _reset_counts()
        t0 = time.perf_counter()
        res = api.solve(A, b, dtype=np.float32, device=dev, s=CACG_S, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        cacg.cacg_loop = loop
    n4, n_outer = spmv_dia_cuda.launches, len(outer)
    _require(res.outer_steps == n_outer,
             f"{tag}: the result says {res.outer_steps} outer steps, the loop made {n_outer}")
    want = 1 + 2 * CACG_S * n_outer
    _require(n4 == want, f"{tag}: {n4} spmv_dia launches, {n_outer} outer steps imply {want}")
    _require(len(reads) == 1 + n_outer, f"{tag}: {len(reads)} dot reads, {n_outer} outer steps")
    true = true_of(res.x.cpu().numpy().astype(np.float64))
    reported = float(res.residual)
    if require:
        _require(res.converged and true <= TRUE_REL,
                 f"{tag}: converged {res.converged} in {res.iterations}, true rel {true:.3e}")
    ratio = true / reported if reported > 0 else float("inf")
    _require(1.0 / CACG_HONEST <= ratio <= CACG_HONEST,
             f"{tag}: true residual {true:.3e} against the reported {reported:.3e}")
    print(f"{tag}: {res.iterations} iterations (cg {cg_its}), converged {res.converged}, "
          f"{n_outer} outer steps, spmv_dia {n4} = 1 + {2 * CACG_S} per outer step, host reads "
          f"2 per outer step (+1), true fp64 rel residual {true:.3e} vs reported {reported:.3e}; "
          f"wall {wall:.3f} s [{card}]")
    count(f"least squares: {tag}", {"spmv_dia": n4})
    return res


def _cacg(fsys, dev, card, count):
    """cacg (s = 4) and jacobi_cacg on the flagship beside cg; cacg on
    Poisson CACG_GRID as DIA beside cg, capped at CACG_CAP times cg's
    count, held to honesty where it does not converge."""
    from conjugategradient_tpu_torch.solvers.cacg import cacg_solve

    f_true = lambda x: _host_rel_residual(fsys.A, fsys.b, x)
    _reset_counts()
    cg = api.solve(fsys.A, fsys.b, method="cg", tol=TOL, norm="rel_l2", dtype=np.float32,
                   device=dev)
    print(f"flagship cg fp32: {cg.iterations} iterations, spmv_dia {spmv_dia_cuda.launches}")
    A32 = fsys.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(fsys.b.astype(np.float32)).to(dev)
    for method in ("cacg", "jacobi_cacg"):
        _cacg_route(f"flagship {method} s={CACG_S}", fsys.A, fsys.b, dev, card, count, f_true,
                    cg.iterations, method=method, tol=TOL, norm="rel_l2")
    warm = lambda: cacg_solve(A32, b32, policy=ConvergencePolicy(tol=TOL, norm="rel_l2"),
                              s=CACG_S)
    walls = _wall_median_ms(warm)
    warm_ms = walls[0]
    print(f"flagship cacg warm wall {_fmt_wall(walls)} [{card}]")
    _device_time_top(warm, warm_ms, card, top=4)

    p = generators.poisson_system(CACG_GRID)
    p_true = lambda x: _host_rel_residual(p.A, p.b, x)
    cgp = api.solve(p.A, p.b, method="cg", tol=TOL, norm="rel_l2", dtype=np.float32, device=dev)
    print(f"Poisson {CACG_GRID} DIA cg fp32: {cgp.iterations} iterations, converged "
          f"{cgp.converged}")
    res = _cacg_route(f"Poisson {CACG_GRID} DIA cacg s={CACG_S} (cap {CACG_CAP}x cg)", p.A, p.b,
                      dev, card, count, p_true, cgp.iterations, require=False, method="cacg",
                      tol=TOL, norm="rel_l2", max_iteration=CACG_CAP * cgp.iterations)
    if not res.converged:
        print(f"Poisson {CACG_GRID} cacg s={CACG_S} fp32 did not converge within "
              f"{CACG_CAP}x cg's count: reported honestly (converged=False)")


def _deflation(dev, card, count):
    """make_deflation on the outlier system at the flagship's size, cg
    against deflated_cg, a DEFL_SEQ-solve sequence reusing the deflation,
    and refined_solve(deflation=) on the host and device-residual routes."""
    from conjugategradient_tpu_torch.solvers.cg import cg_solve as _cg
    from conjugategradient_tpu_torch.solvers.deflation import deflated_cg_solve, make_deflation

    n = TWIN_N
    t0 = time.perf_counter()
    s = generators.outlier_system(n, band=OUTLIER_BAND, n_outliers=OUTLIERS, scale=OUTLIER_SCALE)
    print(f"outlier system n {n} band {OUTLIER_BAND}, {OUTLIERS} outliers at {OUTLIER_SCALE}: "
          f"built in {time.perf_counter() - t0:.3f} s")
    _reset_counts()
    t0 = time.perf_counter()
    d = make_deflation(s.A, k=DEFL_K, device=dev)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    m = max(4 * DEFL_K, 32)
    by = dict(spmv_dia_cuda.launches_by_dtype)
    _require(by.get("fp32", 0) == m and by.get("fp64", 0) == DEFL_K,
             f"make_deflation: spmv_dia launches by dtype {by}, want {m} fp32 (Lanczos) and "
             f"{DEFL_K} fp64 (AW)")
    print(f"make_deflation k={DEFL_K} m={m}: {setup:.3f} s, by phase "
          f"{ {k: round(v, 4) for k, v in d.setup_s.items()} }, spmv_dia {by} [{card}]")
    count("least squares: deflation probe (fp32 Lanczos)", {"spmv_dia": by.get("fp32", 0)})
    count("deflation AW (fp64)", {"spmv_dia": by.get("fp64", 0)}, fp32=False)

    A32 = s.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=PLAIN_CAP)
    true_of = lambda b_, x: _host_rel_residual(s.A, b_, x.cpu().numpy().astype(np.float64))
    _reset_counts()
    plain = _cg(A32, b32, policy=pol)
    torch.cuda.synchronize()
    _require(spmv_dia_cuda.launches == plain.iterations + 1, "plain cg launches")
    print(f"outlier plain cg (cap {PLAIN_CAP}): {plain.iterations} iterations, converged "
          f"{plain.converged}{'' if plain.converged else ' (stalled at the cap)'}, true rel "
          f"{true_of(s.b, plain.x):.3e} [{card}]")
    tag = f"outlier deflated_cg k={DEFL_K}"
    res, got, warm_ms = _nonsym_route(
        tag, s.A, s.b, dev, card, lambda r: r.iterations + 3,
        lambda: deflated_cg_solve(A32, b32, policy=pol, deflation=d),
        lambda x: _host_rel_residual(s.A, s.b, x), median=True, method="deflated_cg",
        deflation=d, tol=TOL, norm="rel_l2", max_iteration=PLAIN_CAP)
    n4 = got["spmv_dia"]
    rel = true_of(s.b, res.x)
    plain_w = _wall_median_ms(lambda: _cg(A32, b32, policy=pol))
    print(f"{tag}: {res.iterations} iterations against plain cg's {plain.iterations}, true fp64 "
          f"rel {rel:.3e}; warm wall {warm_ms:.3f} ms (median) against plain cg's "
          f"{_fmt_wall(plain_w)} [{card}]")
    count(f"least squares: {tag}", {"spmv_dia": n4})

    rng = np.random.default_rng(SEED + 15)
    tot_plain, tot_defl, seq = 0, m, []
    _reset_counts()
    for _ in range(DEFL_SEQ):
        bk = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dev)
        rp = _cg(A32, bk, policy=pol)
        rd = deflated_cg_solve(A32, bk, policy=pol, deflation=d)
        _require(rd.converged, "deflated sequence: a solve did not converge")
        tot_plain += rp.iterations
        tot_defl += rd.iterations
        seq.append((rp.iterations, rd.iterations))
    torch.cuda.synchronize()
    _require(tot_defl < tot_plain, f"deflated sequence: probe {m} + deflated {tot_defl - m} "
             f"products against plain cg's {tot_plain}")
    print(f"outlier sequence of {DEFL_SEQ} seeded b (plain, deflated iterations) {seq}: probe {m} "
          f"+ deflated {tot_defl - m} = {tot_defl} products against plain cg's {tot_plain} [{card}]")
    count("least squares: outlier sequence (plain + deflated)", {"spmv_dia": spmv_dia_cuda.launches})

    for dev_res in (False, True):
        route = "device residual" if dev_res else "host residual"
        out = {}
        for defl in (None, d):
            _reset_counts()
            t0 = time.perf_counter()
            rf = refined_solve(s.A, s.b, tol=FLAGSHIP_TOL, deflation=defl, device=dev,
                               device_residual=dev_res)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            r_abs = float(np.linalg.norm(s.b - oracle.spmv(s.A, rf.x)))
            _require(rf.converged and r_abs < FLAGSHIP_TOL,
                     f"refined {route} deflated={defl is not None}: converged {rf.converged}, "
                     f"||r|| {r_abs:.3e}")
            extra = 3 if defl is not None else 1
            want = rf.inner_iterations + extra * rf.outer_iterations + (
                rf.outer_iterations + 1 if dev_res else 0)
            n4 = spmv_dia_cuda.launches
            _require(n4 == want, f"refined {route}: {n4} spmv_dia launches, the passes imply {want}")
            out[defl is not None] = (rf.outer_iterations, rf.inner_iterations, round(wall, 3),
                                     float(f"{r_abs:.3e}"), n4)
            if defl is not None:
                by = spmv_dia_cuda.launches_by_dtype
                count(f"least squares: outlier refined deflated, {route}",
                      {"spmv_dia": by.get("fp32", 0)})
                count(f"outlier refined deflated, {route}, fp64 residual",
                      {"spmv_dia": by.get("fp64", 0)}, fp32=False)
        _require(out[True][1] < out[False][1],
                 f"refined {route}: deflated inner {out[True][1]} not below {out[False][1]}")
        print(f"outlier refined_solve {route} to ||r||_2 < {FLAGSHIP_TOL}: (outer, inner, wall s, "
              f"||r||, spmv_dia) undeflated {out[False]}, deflated {out[True]} [{card}]")


def _adjoints(fsys, dev, card, count):
    """cg_solve_implicit on the flagship and bicgstab_solve_implicit on the
    twin (its A^T from dia_transpose_traced equal to formats.transpose), in
    fp64, both against central differences; the coefficient recovery of
    the inverse demo at its own size, held to its goal."""
    from conjugategradient_tpu_torch.core.formats import transpose
    from conjugategradient_tpu_torch.scripts.inverse_demo import meets_goal, recover
    from conjugategradient_tpu_torch.solvers.diff import (
        bicgstab_solve_implicit,
        cg_solve_implicit,
        dia_transpose_traced,
    )

    A = fsys.A
    offs, shape, n = A.offsets, A.shape, A.n
    pol = ConvergencePolicy(tol=IMPLICIT_TOL, norm="rel_l2", max_iteration=2000)
    rng = np.random.default_rng(SEED + 15)
    w = torch.from_numpy(rng.standard_normal(n)).to(dev)
    data0 = torch.from_numpy(A.data).to(dev)
    b0 = torch.from_numpy(fsys.b).to(dev)
    data, b = data0.clone().requires_grad_(), b0.clone().requires_grad_()
    _reset_counts()
    t0 = time.perf_counter()
    loss = torch.dot(w, cg_solve_implicit(data, b, offs, shape, pol))
    torch.cuda.synchronize()
    fwd = time.perf_counter() - t0
    n_fwd = spmv_dia_cuda.launches
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    bwd = time.perf_counter() - t0
    n_bwd = spmv_dia_cuda.launches - n_fwd
    _require(n_fwd > 1 and n_bwd > 1 and spmv_dia_cuda.launches_by_dtype.get("fp64") ==
             n_fwd + n_bwd, f"implicit cg: spmv_dia {n_fwd} forward, {n_bwd} backward")
    count("implicit cg flagship fp64 (forward + adjoint)", {"spmv_dia": n_fwd + n_bwd}, fp32=False)

    value = lambda d, bb: float(torch.dot(w, cg_solve_implicit(d, bb, offs, shape, pol)))
    errs = _fd_errors(value, data0, b0, data.grad, b.grad, offs, rng, symmetric=True)
    worst = max(e[2] for e in errs)
    _require(worst <= FD_REL, f"implicit cg: gradients against central differences {errs}")
    print(f"implicit cg flagship fp64: forward {fwd:.3f} s ({n_fwd} spmv_dia), backward {bwd:.3f} s "
          f"({n_bwd}); gradients against central differences, worst rel {worst:.2e} "
          f"{[(kind, where, float(f'{e:.1e}')) for kind, where, e in errs]} [{card}]")

    s = generators.nonsymmetric_banded_system(TWIN_N, TWIN_BAND)
    dT = dia_transpose_traced(torch.from_numpy(s.A.data).to(dev), s.A.offsets, s.n).cpu().numpy()
    At = transpose(s.A)
    order = np.argsort([-o for o in s.A.offsets], kind="stable")
    _require(At.offsets == tuple(-s.A.offsets[k] for k in order)
             and np.array_equal(dT[order], At.data),
             "dia_transpose_traced on the card differs from formats.transpose")
    data0 = torch.from_numpy(s.A.data).to(dev)
    b0 = torch.from_numpy(s.b).to(dev)
    data, bt = data0.clone().requires_grad_(), b0.clone().requires_grad_()
    pol = ConvergencePolicy(tol=IMPLICIT_TOL, norm="rel_l2")
    w = torch.from_numpy(rng.standard_normal(s.n)).to(dev)
    _reset_counts()
    x = bicgstab_solve_implicit(data, bt, s.A.offsets, s.A.shape, pol)
    n_fwd = spmv_dia_cuda.launches
    torch.dot(w, x).backward()
    torch.cuda.synchronize()
    n_bwd = spmv_dia_cuda.launches - n_fwd
    _require(n_bwd > 1, f"implicit bicgstab: {n_bwd} spmv_dia in the adjoint")
    count("implicit bicgstab twin fp64 (forward + adjoint)", {"spmv_dia": n_fwd + n_bwd}, fp32=False)
    value = lambda d, bb: float(torch.dot(w, bicgstab_solve_implicit(d, bb, s.A.offsets,
                                                                      s.A.shape, pol)))
    errs = _fd_errors(value, data0, b0, data.grad, bt.grad, s.A.offsets, rng, symmetric=False)
    worst = max(e[2] for e in errs)
    _require(worst <= FD_REL, f"implicit bicgstab: gradients against central differences {errs}")
    print(f"implicit bicgstab nonsymmetric twin fp64: A^T by dia_transpose_traced on the card equals "
          f"formats.transpose; spmv_dia {n_fwd} forward, {n_bwd} adjoint; gradients against "
          f"central differences, worst rel {worst:.2e} "
          f"{[(kind, where, float(f'{e:.1e}')) for kind, where, e in errs]} [{card}]")

    demo = recover(device=dev)  # the demo's own size and 400 steps
    _require(meets_goal(demo), f"inverse demo: loss {demo['loss0']:.3e} -> {demo['loss']:.3e}, "
             f"coefficient error {demo['coeff_err']:.3e}")
    print(f"inverse demo fp64 (n=192, band 8, {len(demo['losses'])} Adam steps): loss "
          f"{demo['loss0']:.3e} -> {demo['loss']:.3e}, coefficient error {demo['coeff_err']:.3e}, "
          f"{demo['wall_s']:.3f} s [{card}]")


def _fd_errors(value, data0, b0, grad_data, grad_b, offs, rng, symmetric):
    """Relative differences of a solve's gradients from central differences
    of ``value(data, b)`` (a linear loss of the solution, without grad) at
    FD_ENTRIES seeded entries of b and FD_ENTRIES in-band entries of data:
    with ``symmetric`` each data step moves an entry and its mirror, as a
    symmetric A's gradient is read."""
    n = b0.numel()
    errs = []
    with torch.no_grad():
        for i in rng.choice(n, FD_ENTRIES, replace=False):
            e = torch.zeros(n, dtype=b0.dtype, device=b0.device)
            e[int(i)] = FD_STEP_B
            fd = (value(data0, b0 + e) - value(data0, b0 - e)) / (2 * FD_STEP_B)
            errs.append(("b", int(i), abs(float(grad_b[int(i)]) - fd) / abs(fd)))
        while len(errs) < 2 * FD_ENTRIES:
            k = int(rng.integers(0, len(offs)))
            i = int(rng.integers(0, n))
            j = i + offs[k]
            if (symmetric and offs[k] == 0) or not 0 <= j < n:
                continue
            step = torch.zeros_like(data0)
            step[k, i] = FD_STEP_DATA
            an = float(grad_data[k, i])
            if symmetric:
                km = offs.index(-offs[k])
                step[km, j] = FD_STEP_DATA
                an += float(grad_data[km, j])
            fd = (value(data0 + step, b0) - value(data0 - step, b0)) / (2 * FD_STEP_DATA)
            errs.append(("data", (k, i), abs(an - fd) / abs(fd)))
    return errs


def _precision_helpers(dev, card):
    """dd_dot, kahan_sum and promote_dot on PREC_N fp32 elements against a
    numpy fp64 witness, within the JAX docstrings' bounds: the double-float
    tree's final rounding to fp32 plus PREC_TREE log2(n) eps^2 of sum |a b|
    (of sum |x|), a plain fp32 dot n eps of it.  Twice: on random data of
    six decades, and on a cancelling input (the data and its negation
    scaled by 1 - 2^-12, shuffled), where the exact value is about 1e-6 of
    the terms' sum; there the compensated two must also stay PREC_GAIN
    below the plain fp32 reduction's error (torch.dot, torch.sum), which a
    sum without the compensation would not."""
    from conjugategradient_tpu_torch.ops import precision

    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    half = PREC_N // 2
    a = torch.randn(PREC_N, generator=gen, device=dev) * 10.0 ** (
        torch.rand(PREC_N, generator=gen, device=dev) * 6 - 3)
    b = torch.randn(PREC_N, generator=gen, device=dev)
    perm = torch.randperm(PREC_N, generator=gen, device=dev)
    shrink = 1.0 - 2.0 ** -12
    inputs = {"random": (a, b, a),
              "cancelling": (torch.cat([a[:half], a[:half]])[perm],
                             torch.cat([b[:half], -(b[:half] * shrink)])[perm],
                             torch.cat([a[:half], -(a[:half] * shrink)])[perm])}
    eps = float(np.finfo(np.float32).eps)
    tree = PREC_TREE * np.log2(PREC_N) * eps * eps
    for label, (u, v, x) in inputs.items():
        u64, v64, x64 = (t.double().cpu().numpy() for t in (u, v, x))
        prods = u64 * v64  # exact: fp32 x fp32 fits in fp64
        exact_dot, mag_dot = float(np.sum(prods)), float(np.sum(np.abs(prods)))
        exact_sum, mag_sum = float(np.sum(x64)), float(np.sum(np.abs(x64)))
        errs, rows = {}, {}
        for name, fn, exact, mag, bound in (
                ("dd_dot", lambda: precision.dd_dot(u, v), exact_dot, mag_dot,
                 eps * abs(exact_dot) + tree * mag_dot),
                ("kahan_sum", lambda: precision.kahan_sum(x), exact_sum, mag_sum,
                 eps * abs(exact_sum) + tree * mag_sum),
                ("promote_dot", lambda: precision.promote_dot(u, v), exact_dot, mag_dot,
                 PREC_N * eps * mag_dot),
                ("torch.dot fp32", lambda: torch.dot(u, v), exact_dot, mag_dot,
                 PREC_N * eps * mag_dot),
                ("torch.sum fp32", lambda: torch.sum(x), exact_sum, mag_sum,
                 PREC_N * eps * mag_sum)):
            err = abs(float(fn()) - exact)
            _require(err <= bound, f"{name} ({label}): error {err:.3e} against the fp64 witness, "
                     f"bound {bound:.3e}")
            errs[name] = err
            rows[name] = (float(f"{err / mag:.2e}"), round(time_ms(fn, 5), 4))
        if label == "cancelling":
            for name, plain in (("dd_dot", "torch.dot fp32"), ("kahan_sum", "torch.sum fp32")):
                _require(errs[name] <= PREC_GAIN * errs[plain],
                         f"{name} ({label}): error {errs[name]:.3e} not {PREC_GAIN} of the plain "
                         f"{plain}'s {errs[plain]:.3e}")
        print(f"precision helpers on {PREC_N} fp32 elements, {label} (exact dot / sum|ab| "
              f"{exact_dot / mag_dot:.1e}; error / sum|terms|, ms): {rows} [{card}]")


#: route -> (system, api.solve keywords) of the fp64 card-against-CPU
#: checks of this phase's routes
LSQ_SMALL = {
    "cgnr band": ("band", dict(method="cgnr")),
    "lsmr band": ("band", dict(method="lsmr")),
    "lsmr regression damped": ("regression", dict(method="auto", damp=LSQ_DAMP)),
    "cacg Poisson": ("poisson", dict(method="cacg")),
    "jacobi_cacg banded": ("banded", dict(method="jacobi_cacg")),
    "deflated_cg outlier": ("outlier", dict(method="deflated_cg")),
    "refined deflated outlier": ("outlier", dict(method="refined", device_dtype=np.float64)),
    "refined deflated grid Poisson": ("poisson", dict(method="refined", grid=(63, 63),
                                                      device_dtype=np.float64)),
}


def _lsq_small_system(kind):
    """(A, b) of a LSQ_SMALL route."""
    if kind == "regression":
        S, b = _regression(4096, 1024, LSQ_NNZ, SEED)
        return from_scipy(S), b
    s = {"band": lambda: generators.nonsymmetric_banded_system(63 * 63, 16),
         "banded": lambda: generators.banded_sin_system(63 * 63, 16),
         "outlier": lambda: generators.outlier_system(4096, band=16),
         "poisson": lambda: generators.poisson_system((63, 63))}[kind]()
    return s.A, s.b


def _lsq_card_vs_cpu(dev, card):
    """Each new route in fp64 on the card and on the CPU (a deflation built
    on the CPU, the same basis on both): equal counts, x within LSQ_AGREE;
    the implicit gradients too."""
    from conjugategradient_tpu_torch.solvers.deflation import make_deflation
    from conjugategradient_tpu_torch.solvers.diff import cg_solve_implicit

    def deflation(route, A):
        if "deflated" not in route:
            return {}, {}
        d = make_deflation(A, k=4, m=32, dtype=np.float64, device="cpu")
        return dict(deflation=d), dict(deflation=d.to(dev))

    label = "least squares, s-step, deflation, adjoints fp64 small"
    out = _card_vs_cpu(dev, card, label, LSQ_SMALL, _lsq_small_system, LSQ_AGREE, deflation)
    s = generators.banded_sin_system(63 * 63, 16)
    grads = {}
    for where in ("cpu", dev):
        data = torch.from_numpy(s.A.data).to(where).requires_grad_()
        bb = torch.from_numpy(s.b).to(where).requires_grad_()
        w = torch.from_numpy(np.random.default_rng(SEED).standard_normal(s.n)).to(where)
        torch.dot(w, cg_solve_implicit(data, bb, s.A.offsets, s.A.shape,
                                       ConvergencePolicy(tol=1e-12, norm="rel_l2"))).backward()
        grads[str(where)] = (data.grad.cpu().numpy(), bb.grad.cpu().numpy())
    (dc, bc), (dg, bg) = grads["cpu"], grads[str(dev)]
    dgrad = max(float(np.abs(dg - dc).max() / np.abs(dc).max()),
                float(np.abs(bg - bc).max() / np.abs(bc).max()))
    _require(dgrad <= LSQ_AGREE, f"card vs CPU implicit cg gradients differ by {dgrad:.3e}")
    print(f"{label}: cg_solve_implicit band gradients, card against CPU, max rel diff "
          f"{dgrad:.2e} [{card}]")
    return out


def _least_squares(fsys, dev, card, count):
    """Least squares, s-step CG, deflation and the adjoints on the card;
    returns the transposed-DIA record of kernel #4."""
    t0 = time.perf_counter()
    rec = _transposed_dia(dev, card, count)
    print(f"  transposed_dia: {time.perf_counter() - t0:.1f} s")
    for step in (_rectangular_lsmr, _deflation):
        t0 = time.perf_counter()
        step(dev, card, count)
        print(f"  {step.__name__.lstrip('_')}: {time.perf_counter() - t0:.1f} s")
    for step in (_cacg, _adjoints):
        t0 = time.perf_counter()
        step(fsys, dev, card, count)
        print(f"  {step.__name__.lstrip('_')}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _precision_helpers(dev, card)
    _lsq_card_vs_cpu(dev, card)
    print(f"  precision helpers, card vs CPU: {time.perf_counter() - t0:.1f} s")
    return rec


# ---------------------------------------------------------------------------
# eigensolvers
# ---------------------------------------------------------------------------

#: LOBPCG by the facade: the k smallest pairs of poisson_system(EIG_GRID).A
#: with the MGCG hierarchy's V-cycle as M; cut from the main path's 1023^2
#: (31.6 s for the step there) to keep the run inside its time limit with
#: the rung-5 phase.  Kernel #5 at LOBPCG's A pass stays timed at
#: EIG_SPMM_GRID
EIG_GRID = (511, 511)
EIG_SPMM_GRID = (1023, 1023)
#: the grid of auto's probe, timed apart: cut from 1023^2 (21.6 s of host
#: symmetry and Lanczos on 1M rows) to keep the run inside its time limit
EIG_PROBE_GRID = (511, 511)
EIG_K = 8
#: the fp64 eigenvalues against the closed form, relative
EIG_CLOSED = 1e-6
#: ||X^T X - I||_max (X^T B X for the generalized problem) by dtype
EIG_ORTH = {torch.float32: 1e-5, torch.float64: 1e-10}
#: the true fp64 host residual within EIG_TRUE times the reported one, plus
#: the rounding of one evaluation of A x - lambda x at a unit x in the
#: solve's dtype (``_floor``): a reported residual under that is noise (the
#: JAX package's fp32 Arnoldi artifact reads 3.7e-7 against a true 9.9e-7
#: for its sixth LM pair)
EIG_TRUE = 2.0
EIG_REPS = 3
#: the profiled window: iterations (LOBPCG) or restarts (Arnoldi)
EIG_WINDOW = 2
#: the generalized problem: A x = lambda B x, B the tridiagonal mass
#: matrix (4/6, 1/6), a V-cycle M, fp64, against scipy's eigsh(sigma=0);
#: cut from 511^2 (12.3 s, 8.1 of them scipy's eigsh on the host) to keep
#: the run inside its time limit
GEN_GRID = (255, 255)
GEN_K = 4
GEN_WITNESS = 1e-8
#: Arnoldi at the JAX package's eigen workload (artifacts/
#: arnoldi_onchip_r04.json, scripts/arnoldi_onchip.py): convection-diffusion
#: 511^2 eps 0.1 in fp32, m = 32, compensated dots; (which, k, tol).  Its
#: free residual estimate reads under the fp32 floor of a Ritz vector summed
#: from m basis rows: the true residuals are held to EIG_TRUE x the estimate
#: plus _floor x sqrt(m) (the card's LR pair: 2.4e-7 reported, 1.6e-6 true)
CD_GRID = (511, 511)
CD_EPS = 0.1
CD_M = 32
CD_ROUTES = (("LM", 6, 2e-6), ("LR", 4, 1e-6))
CD_ARTIFACT = os.path.join("artifacts", "arnoldi_onchip_r04.json")
#: LM at ARPACK_GRID in fp64 against scipy's eigs (ARPACK): the clustered,
#: nonnormal top of this spectrum moves its eigenvalues by up to 8e-7
#: relative between two solvers at tol 1e-10 (the port's m = 48 against
#: ARPACK's ncv 64, 3.5e-7; ARPACK's ncv 32, 64 and 96 among themselves,
#: 3e-8; CPU runs), so the witness holds to ARPACK_AGREE
ARPACK_GRID = (127, 127)
ARPACK_AGREE = 1e-5
ARPACK_M = 48
#: shift-invert: sigma = 0 on convection-diffusion SI_GRID eps 0.1, inner
#: IDR(4) on #4 preconditioned by the V-cycle of A (plain IDR takes 82,610
#: inner matvecs at fp64 on the 127^2 operator, a CPU run), against
#: ARPACK's sigma = 0.  At 127^2 a warm call takes 8.3 s in fp32 and 21.8 s
#: in fp64 on the card (1,595 / 4,175 inner matvecs of ~175 eager ops each:
#: ``_shift_invert(grid=(127, 127))``), so the smoke runs 63^2.  Both at
#: arnoldi_eigs' default inner_tol, SI_INNER by dtype (fp32's is the port's,
#: above the floor of its IDR exit, which accepts only a recomputed b - A x);
#: each inverse exact to that relative level moves the values by as much,
#: so fp32 holds to it
SI_GRID = (63, 63)
SI_K = 4
SI_INNER = {torch.float32: 1e-3, torch.float64: 1e-10}
SI_AGREE = {torch.float32: SI_INNER[torch.float32], torch.float64: 1e-9}
SI_MAX_RESTARTS64 = 3
#: card against CPU, fp64: values within EIG_AGREE (relative), every count
#: equal
EIG_AGREE = 1e-10
EIG_SMALL = {"lobpcg Poisson 31^2 k=4 V-cycle M": ("poisson", dict(k=4, which="SM", spd=True,
                                                                   grid=(31, 31))),
             "arnoldi convection 16^2 LM k=4": ("cd", dict(k=4, which="LM", tol=1e-10)),
             "arnoldi convection 16^2 sigma=0 k=3": ("cd", dict(k=3, sigma=0.0, tol=1e-10))}


def _eig_counts():
    """The launch counts of #4, #5 and the V-cycle's kernels."""
    return {"spmv_dia": spmv_dia_cuda.launches, "spmm_dia": spmm_dia_cuda.launches,
            "spmv_const_stencil": spmv_const_stencil_cuda.launches,
            "cheb_smooth_const": cheb_smooth_const_cuda.launches,
            "spmv_stencil": spmv_stencil_cuda.launches,
            "spmv_stencil_wide": spmv_stencil_wide_cuda.launches}


def _cycle_launches(h, dtype, dev):
    """Each kernel's launches in one V-cycle of ``h`` on a flat vector."""
    cycle = as_preconditioner(h)
    n = h.levels[0].A.n if h.levels else h.coarse_inv.shape[0]
    r = torch.from_numpy(np.random.default_rng(SEED).standard_normal(n))
    _reset_counts()
    cycle(r.to(dev, dtype))
    torch.cuda.synchronize()
    return {k: v for k, v in _eig_counts().items() if v}


def _require_cycles(tag, got, per_cycle, cycles):
    """The V-cycle kernels launched exactly ``cycles`` cycles' worth."""
    for name, n in per_cycle.items():
        _require(got[name] == n * cycles, f"{tag}: {got[name]} {name} launches, {cycles} "
                 f"V-cycles of {n} imply {n * cycles}")
    return {name: f"{got[name]} = {cycles} x {n}" for name, n in per_cycle.items()}


def _floor(A, dtype, lam):
    """eps(dtype) (max row sum of |A| + |lambda|), per value: the rounding
    of one evaluation of A x - lambda x, or of x itself, in ``dtype``."""
    rows = float(np.max(np.abs(to_scipy(A).tocsr()).sum(axis=1)))
    return torch.finfo(dtype).eps * (rows + np.abs(np.asarray(lam)))


def _true_pair_residuals(csr, X, lam, Bcsr=None):
    """||A x - lambda B x||_2 in fp64 on the host, per column of X."""
    X = np.asarray(X, np.complex128)
    BX = X if Bcsr is None else Bcsr @ X.real + 1j * (Bcsr @ X.imag)
    AX = csr @ X.real + 1j * (csr @ X.imag)
    return np.linalg.norm(AX - BX * lam[None, :], axis=0)


def _check_true(tag, true, reported, floor):
    """Each true residual within EIG_TRUE times its reported one plus the
    dtype's floor; returns the worst true / reported ratio."""
    floor = np.broadcast_to(floor, true.shape)
    bad = true > EIG_TRUE * reported + floor
    _require(not bad.any(), f"{tag}: true residuals {true[bad]} exceed {EIG_TRUE} x the "
             f"reported {reported[bad]} + floor {floor[bad]}")
    return float(np.max(true / np.maximum(reported, 1e-300)))


def _poisson_closed_form(grid, k: int) -> np.ndarray:
    """The k smallest eigenvalues of the 2-D 5-point Laplacian (diagonal 4,
    unit spacing): 4 sin^2(i pi / (2 (nx + 1))) + 4 sin^2(j pi / (2 (ny +
    1)))."""
    lx, ly = (4.0 * np.sin(np.arange(1, g + 1) * np.pi / (2 * (g + 1))) ** 2 for g in grid)
    return np.sort(np.add.outer(lx, ly).ravel())[:k]


def _lobpcg_facade(dev, card, count):
    """``api.eigs(A, k=EIG_K, which="SM", grid=EIG_GRID)`` on Poisson
    EIG_GRID in fp32 and fp64 (spd=True; ``auto``'s probe timed apart, on
    EIG_PROBE_GRID):
    #5 launched ceil-chunks of k once and of 3k per iteration, the V-cycle
    kernels k cycles an iteration; the fp64 values against the closed form,
    the fp32 ones against the fp64 ones within a residual and gap bound,
    true residuals, orthonormality; the warm wall, its fixed cost split
    (``_lobpcg_setup_ms``), the busy share."""
    from conjugategradient_tpu_torch.core.formats import is_symmetric
    from conjugategradient_tpu_torch.precond import multigrid
    from conjugategradient_tpu_torch.solvers.lobpcg import lobpcg

    s = generators.poisson_system(EIG_GRID)
    A = s.A
    csr = to_scipy(A).tocsr()
    exact = _poisson_closed_form(EIG_GRID, EIG_K + 4)
    P = generators.poisson_system(EIG_PROBE_GRID).A
    t0 = time.perf_counter()
    sym = is_symmetric(P, tol=1e-12 * api._diag_scale(P)) and api._spd_probe(P, device=dev)
    torch.cuda.synchronize()
    probe_s = time.perf_counter() - t0
    _require(sym, f"auto's probe on Poisson {EIG_PROBE_GRID}: not SPD")
    print(f"eigs auto's probe on Poisson {EIG_PROBE_GRID} (symmetry, host Lanczos, card Lanczos): "
          f"{probe_s:.3f} s, SPD -> lobpcg; the routes below pass spd=True [{card}]")
    out = {}
    for dt in (torch.float32, torch.float64):
        tag = f"eigs lobpcg Poisson {EIG_GRID} k={EIG_K} SM V-cycle {TAGS[dt]}"
        _reset_counts()
        t0 = time.perf_counter()
        with _facade_built(multigrid, "build_hierarchy") as built:
            r = api.eigs(A, k=EIG_K, which="SM", grid=EIG_GRID, spd=True, dtype=dt, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _eig_counts()
        h = built[0]
        its = r.restarts
        _require(r.converged, f"{tag}: not converged in {its} iterations")
        want5 = len(k_chunks(EIG_K)) + its * len(k_chunks(3 * EIG_K))
        _require(got["spmm_dia"] == want5, f"{tag}: {got['spmm_dia']} spmm_dia launches, the "
                 f"recurrence implies {want5}")
        _require(got["spmv_dia"] == 0, f"{tag}: {got['spmv_dia']} spmv_dia launches")
        per_cycle = _cycle_launches(h, dt, dev)
        cyc = _require_cycles(tag, got, per_cycle, its * EIG_K)
        count(f"eigensolvers: {tag}", got, fp32=dt == torch.float32)
        lam = r.values.real
        X = r.vectors.real
        reported = r.residuals  # ||A x - lam x||, the facade's scaling
        true = _true_pair_residuals(csr, X, lam)
        ratio = _check_true(tag, true, reported, _floor(A, dt, lam))
        orth = float(np.abs(X.T @ X - np.eye(EIG_K)).max())
        _require(orth <= EIG_ORTH[dt], f"{tag}: ||X^T X - I||_max {orth:.3e} > {EIG_ORTH[dt]}")
        closed = float(np.max(np.abs(lam - exact[:EIG_K]) / exact[:EIG_K]))
        if dt == torch.float64:
            _require(closed <= EIG_CLOSED, f"{tag}: eigenvalues {closed:.3e} from the closed "
                     f"form, bound {EIG_CLOSED}")
        # warm: the facade's solve on the same M; its fixed cost is the
        # same call stopped before the first iteration
        M = as_multi_preconditioner(h)
        tol = 1e-5 if dt == torch.float32 else 1e-8
        walls = _wall_median_ms(lambda: lobpcg(A, EIG_K, M=M, tol=tol, dtype=dt, device=dev),
                                EIG_REPS)
        fixed = _wall_median_ms(lambda: lobpcg(A, EIG_K, M=M, max_iterations=0, dtype=dt,
                                               device=dev), EIG_REPS)
        parts = _lobpcg_setup_ms(A, dt, dev)
        parts["first orthonormalisation, A pass, residuals"] = fixed[0] - sum(parts.values())
        print(f"{tag}: {its} iterations, matvecs {r.matvecs}, max reported residual "
              f"{reported.max():.3e} (true/reported worst {ratio:.3f}), ||X^T X - I||_max "
              f"{orth:.2e}, values {np.array2string(lam, precision=10)} (closed form max rel "
              f"{closed:.2e}); spmm_dia launches {got['spmm_dia']} (= {len(k_chunks(EIG_K))} + "
              f"{its} x {len(k_chunks(3 * EIG_K))}), V-cycle kernels {cyc}; host setup s "
              f"{ {k: round(v, 3) for k, v in h.setup_s.items()} }, wall {wall:.3f} s with the "
              f"setup; warm wall {_fmt_wall(walls, EIG_REPS)}: fixed (max_iterations=0) "
              f"{_fmt_wall(fixed, EIG_REPS)} of which ms "
              f"{ {k: round(v, 3) for k, v in parts.items()} }, "
              f"{(walls[0] - fixed[0]) / its:.3f} ms an iteration; host reads an iteration: 1 "
              f"(the loop's predicate) + 2 (the two eigh matrices) [{card}]")
        # the busy share of a short window of the same loop: a whole
        # solve's trace takes tens of seconds to read
        window = lambda: lobpcg(A, EIG_K, M=M, max_iterations=EIG_WINDOW, dtype=dt, device=dev)
        _device_time_top(window, _wall_ms(window), card, top=5)
        out[dt] = (lam, X)
    # fp32 against fp64: each value within |lam - theta| + min(r, r^2 /
    # delta) of an eigenvalue, theta and r the fp64 host Rayleigh quotient
    # and residual of its vector, delta theta's distance to the other
    # eigenspaces (closed form); the two runs' values within the sum
    distinct = np.unique(np.round(exact, 12))
    bounds = {dt: _rq_bounds(csr, X, lam, distinct) for dt, (lam, X) in out.items()}
    lam32, lam64 = out[torch.float32][0], out[torch.float64][0]
    bound = bounds[torch.float32] + bounds[torch.float64]
    diff = np.abs(lam32 - lam64)
    _require(np.all(diff <= bound), f"fp32 against fp64 eigenvalues: {diff} beyond {bound}")
    print(f"eigs lobpcg Poisson {EIG_GRID}: fp32 against fp64 eigenvalues |diff| "
          f"{np.array2string(diff, precision=3)} within the Rayleigh-quotient bounds "
          f"{np.array2string(bound, precision=3)} (fp32 {np.array2string(bounds[torch.float32], precision=3)}) "
          f"[{card}]")


def _lobpcg_setup_ms(A, dt, dev):
    """Median host-clock ms of the parts of LOBPCG's set-up, each call as
    ``lobpcg`` makes it: the draws of its two (n, k) start blocks on the
    card, their cast to the solve's dtype, A's placement and block
    operator."""
    from conjugategradient_tpu_torch.core.formats import place
    from conjugategradient_tpu_torch.solvers.lobpcg import _draw
    from conjugategradient_tpu_torch.solvers.multi import _as_multi_operator

    n = A.shape[0]
    X = _draw(n, EIG_K, SEED, dev)
    steps = {"draws": lambda: (_draw(n, EIG_K, SEED, dev), _draw(n, EIG_K, SEED + 1, dev)),
             "their cast": lambda: (place(X, dt, dev), place(X, dt, dev)),
             "A's placement": lambda: _as_multi_operator(A.device_put(dt, dev), dev)}
    return {name: _wall_median_ms(fn, EIG_REPS)[0] for name, fn in steps.items()}


def _rq_bounds(csr, X, lam, distinct):
    """Per column x of X: |lam - theta| + min(r, r^2 / delta), theta = x.Ax
    / x.x and r = ||A x - theta x|| / ||x|| in fp64, delta the distance from
    theta to the nearest of ``distinct`` (the exact eigenvalues) but its
    own: a symmetric A has an eigenvalue within it of lam."""
    out = np.empty(len(lam))
    for i in range(len(lam)):
        x = X[:, i]
        Ax = csr @ x
        nx = float(x @ x)
        theta = float(x @ Ax) / nx
        r = float(np.linalg.norm(Ax - theta * x)) / np.sqrt(nx)
        others = distinct[np.abs(distinct - theta) > 1e-9 * abs(theta)]
        delta = float(np.min(np.abs(others - theta)))
        out[i] = abs(lam[i] - theta) + min(r, r * r / delta)
    return out


def _generalized(dev, card, count):
    """``lobpcg(A, GEN_K, B=mass, M=V-cycle)`` in fp64 on Poisson GEN_GRID:
    A and B both on #5 (k then 3k columns each), k V-cycles an iteration;
    against scipy's ``eigsh(A, M=B, sigma=0)``."""
    import scipy.sparse.linalg as spla

    from conjugategradient_tpu_torch.solvers.lobpcg import lobpcg

    s = generators.poisson_system(GEN_GRID)
    A, n = s.A, s.n
    B = generators.tridiagonal_matrix(n, diag=4.0 / 6.0, off=1.0 / 6.0)
    h = build_hierarchy(A, GEN_GRID, dtype=np.float64, device=dev)
    M = as_multi_preconditioner(h)
    tag = f"lobpcg generalized Poisson {GEN_GRID} B = mass (4/6, 1/6) k={GEN_K} V-cycle fp64"
    run = lambda: lobpcg(A, GEN_K, B=B, M=M, tol=1e-8, dtype=torch.float64, device=dev)
    _reset_counts()
    r = run()
    torch.cuda.synchronize()
    got = _eig_counts()
    its = r.iterations
    _require(r.converged, f"{tag}: not converged in {its} iterations")
    want5 = 2 * (len(k_chunks(GEN_K)) + its * len(k_chunks(3 * GEN_K)))
    _require(got["spmm_dia"] == want5, f"{tag}: {got['spmm_dia']} spmm_dia launches, A and B "
             f"passes imply {want5}")
    cyc = _require_cycles(tag, got, _cycle_launches(h, torch.float64, dev), its * GEN_K)
    count(f"eigensolvers: {tag}", got, fp32=False)
    Acsr, Bcsr = to_scipy(A).tocsc(), to_scipy(B).tocsc()
    t0 = time.perf_counter()
    w = np.sort(spla.eigsh(Acsr, GEN_K, M=Bcsr, sigma=0, which="LM", return_eigenvectors=False))
    scipy_s = time.perf_counter() - t0
    lam = r.eigenvalues.cpu().numpy()
    X = r.eigenvectors.cpu().numpy()
    rel = float(np.max(np.abs(lam - w) / w))
    _require(rel <= GEN_WITNESS, f"{tag}: {rel:.3e} from scipy's eigsh, bound {GEN_WITNESS}")
    borth = float(np.abs(X.T @ (Bcsr @ X) - np.eye(GEN_K)).max())
    _require(borth <= EIG_ORTH[torch.float64], f"{tag}: ||X^T B X - I||_max {borth:.3e}")
    reported = r.residuals.cpu().numpy() * (np.abs(lam) + 1.0)
    true = _true_pair_residuals(Acsr.tocsr(), X, lam, Bcsr.tocsr())
    ratio = _check_true(tag, true, reported, _floor(A, torch.float64, lam))
    walls = _wall_median_ms(run, EIG_REPS)
    print(f"{tag}: {its} iterations, values {np.array2string(lam, precision=10)}, max rel "
          f"{rel:.2e} from scipy eigsh(sigma=0) ({scipy_s:.1f} s on the host), ||X^T B X - "
          f"I||_max {borth:.2e}, true/reported worst {ratio:.3f}; spmm_dia launches "
          f"{got['spmm_dia']} (= 2 x ({len(k_chunks(GEN_K))} + {its} x "
          f"{len(k_chunks(3 * GEN_K))})), V-cycle kernels {cyc}; warm wall "
          f"{_fmt_wall(walls, EIG_REPS)}; host reads an iteration: 3 [{card}]")
    window = lambda: lobpcg(A, GEN_K, B=B, M=M, max_iterations=EIG_WINDOW, dtype=torch.float64,
                            device=dev)
    _device_time_top(window, _wall_ms(window), card, top=4)


def _as_set(vals) -> np.ndarray:
    """Values sorted with each imaginary part's sign dropped: a k cut
    inside a conjugate pair keeps either member."""
    v = np.asarray(vals)
    return np.sort_complex(v.real + 1j * np.abs(v.imag))


def _conjugate_pairs(vals) -> bool:
    """Every complex value has its conjugate among ``vals``, but for the
    last wanted one (the k cut may fall inside a pair)."""
    v = np.asarray(vals)
    scale = max(1.0, float(np.abs(v).max()))
    for i, x in enumerate(v[:-1]):
        if abs(x.imag) > 1e-6 * scale and np.min(np.abs(v - np.conj(x))) > 1e-5 * scale:
            return False
    return True


def _arnoldi_routes(dev, card, count):
    """Arnoldi at the JAX package's eigen workload, fp32: LM and LR on
    convection-diffusion CD_GRID (#4 once per matvec), beside the
    artifact's values; LM at ARPACK_GRID in fp64 against ARPACK."""
    import scipy.sparse.linalg as spla

    from conjugategradient_tpu_torch.solvers.arnoldi import arnoldi_eigs

    with open(CD_ARTIFACT) as f:
        artifact = json.load(f)
    A = generators.convection_diffusion_matrix(CD_GRID, eps=CD_EPS)
    csr = to_scipy(A).tocsr()
    for which, k, tol in CD_ROUTES:
        tag = f"arnoldi convection {CD_GRID} eps {CD_EPS} {which} k={k} tol {tol} m={CD_M} fp32"
        run = lambda: arnoldi_eigs(A, k=k, which=which, tol=tol, m=CD_M, precise_dot=True,
                                   dtype=torch.float32, device=dev)
        _reset_counts()
        t0 = time.perf_counter()
        r = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _eig_counts()
        _require(r.converged, f"{tag}: not converged in {r.restarts} restarts")
        _require(got["spmv_dia"] == r.matvecs, f"{tag}: {got['spmv_dia']} spmv_dia launches "
                 f"for {r.matvecs} matvecs")
        count(f"eigensolvers: {tag}", got)
        true = _true_pair_residuals(csr, r.vectors, r.values)
        # the Ritz vector is a sum of m fp32 basis rows: m roundings more
        floor = _floor(A, torch.float32, r.values) * np.sqrt(CD_M)
        ratio = _check_true(tag, true, r.residuals, floor)
        _require(_conjugate_pairs(r.values), f"{tag}: values {r.values} not in conjugate pairs")
        art = artifact[which]
        ref = np.array(art["values_re"]) + 1j * np.array(art["values_im"])
        walls = _wall_median_ms(run, EIG_REPS)
        print(f"{tag}: {r.matvecs} matvecs, {r.restarts} restarts (the artifact's TPU run: "
              f"{art['matvecs']}, {art['restarts']}), values {np.array2string(r.values, precision=8)} "
              f"(artifact {np.array2string(ref, precision=8)}, max |diff| as sets "
              f"{np.max(np.abs(_as_set(r.values) - _as_set(ref))):.2e}), "
              f"reported {np.array2string(r.residuals, precision=2)}, true fp64 "
              f"{np.array2string(true, precision=2)} (worst ratio {ratio:.3f}); spmv_dia "
              f"launches {got['spmv_dia']} (= matvecs); wall {wall:.3f} s, warm wall "
              f"{_fmt_wall(walls, EIG_REPS)}; host reads a cycle: 1 (S and beta) + 1 at the end "
              f"[{card}]")
        window = lambda: arnoldi_eigs(A, k=k, which=which, tol=tol, m=CD_M, precise_dot=True,
                                      max_restarts=EIG_WINDOW, dtype=torch.float32, device=dev)
        _device_time_top(window, _wall_ms(window), card, top=4)
    A = generators.convection_diffusion_matrix(ARPACK_GRID, eps=CD_EPS)
    r = arnoldi_eigs(A, k=6, which="LM", tol=1e-10, m=ARPACK_M, dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    w = spla.eigs(to_scipy(A).tocsr(), k=6, which="LM", tol=1e-10, ncv=64,
                  return_eigenvectors=False)
    arpack_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(_as_set(r.values) - _as_set(w)) / np.abs(_as_set(w))))
    _require(r.converged and rel <= ARPACK_AGREE,
             f"arnoldi LM {ARPACK_GRID} fp64: converged {r.converged}, {rel:.3e} from ARPACK")
    print(f"arnoldi convection {ARPACK_GRID} LM k=6 fp64 m={ARPACK_M}: {r.matvecs} matvecs, "
          f"{r.restarts} restarts, max rel {rel:.2e} from ARPACK ({arpack_s:.1f} s on the host) "
          f"[{card}]")


def _shift_invert(dev, card, count, grid=SI_GRID):
    """``api.eigs(CD grid, k=SI_K, sigma=0)`` in fp32 and fp64 at the
    default inner_tol: inner IDR(4) on #4 with the V-cycle of A as its M;
    inner_converged, ARPACK's sigma = 0 values, the recomputed residuals
    (one #5 block product)."""
    import scipy.sparse.linalg as spla

    from conjugategradient_tpu_torch.solvers.arnoldi import _shift_apply

    A = generators.convection_diffusion_matrix(grid, eps=CD_EPS)
    csr = to_scipy(A).tocsr()
    w = spla.eigs(csr.tocsc(), k=SI_K, sigma=0.0, return_eigenvectors=False)
    for dt in (torch.float32, torch.float64):
        np_dt = np.float32 if dt == torch.float32 else np.float64
        h = build_hierarchy(A, grid, dtype=np_dt, device=dev)
        cycle, cycles = as_preconditioner(h), [0]

        def M(v):
            cycles[0] += 1
            return cycle(v)

        kw = dict(k=SI_K, sigma=0.0, M=M, dtype=dt, device=dev)
        tag = (f"eigs shift-invert convection {grid} eps {CD_EPS} sigma=0 k={SI_K} inner "
               f"IDR(4) + V-cycle {TAGS[dt]}")
        run = lambda: api.eigs(A, **kw)
        cycles[0] = 0
        _reset_counts()
        r = run()
        torch.cuda.synchronize()
        got = _eig_counts()
        _require(r.converged and r.inner_converged, f"{tag}: converged {r.converged}, inner "
                 f"converged {r.inner_converged}")
        if dt == torch.float64:
            _require(r.restarts <= SI_MAX_RESTARTS64, f"{tag}: {r.restarts} restarts > "
                     f"{SI_MAX_RESTARTS64}")
        # #4: one an application of A - sigma I (each inner solve's
        # matvecs, its replacements and its first residual), at least one a
        # solve; #5: the one block product of the 2k' residual columns
        _require(r.inner_matvecs > r.matvecs and got["spmv_dia"] == r.inner_matvecs,
                 f"{tag}: {got['spmv_dia']} spmv_dia launches, {r.inner_matvecs} applications "
                 f"of A - sigma I in {r.matvecs} inner solves")
        want5 = len(k_chunks(2 * len(r.values)))
        _require(got["spmm_dia"] == want5, f"{tag}: {got['spmm_dia']} spmm_dia launches, the "
                 f"residual recompute implies {want5}")
        cyc = _require_cycles(tag, got, _cycle_launches(h, dt, dev), cycles[0])
        count(f"eigensolvers: {tag}", got, fp32=dt == torch.float32)
        rel = float(np.max(np.abs(_as_set(r.values) - _as_set(w)) / np.abs(_as_set(w))))
        _require(rel <= SI_AGREE[dt], f"{tag}: {rel:.3e} from ARPACK sigma=0, bound {SI_AGREE[dt]}")
        true = _true_pair_residuals(csr, r.vectors, r.values)
        _require(np.allclose(true, r.residuals, rtol=1e-3, atol=_floor(A, dt, r.values)),
                 f"{tag}: recomputed residuals {r.residuals} against the host's {true}")
        walls = _wall_median_ms(run, EIG_REPS)
        print(f"{tag}: {r.matvecs} inner solves ({r.inner_matvecs} applications of A - sigma I), "
              f"{r.restarts} restarts, values {np.array2string(r.values, precision=10)}, "
              f"max rel {rel:.2e} from ARPACK sigma=0, residuals "
              f"{np.array2string(r.residuals, precision=2)} (host fp64 "
              f"{np.array2string(true, precision=2)}); spmv_dia launches {got['spmv_dia']} (= "
              f"applications of A - sigma I), spmm_dia {got['spmm_dia']}, "
              f"V-cycle kernels {cyc}; warm wall {_fmt_wall(walls, EIG_REPS)}; host reads: 1 a cycle + "
              f"the inner IDR's one a cycle [{card}]")
        # the window: one inner solve of the shifted system
        apply, _ = _shift_apply(as_operator(A.device_put(dt, dev)), 0.0, M, SI_INNER[dt], 10000,
                                "idr")
        v = torch.from_numpy(np.random.default_rng(SEED).standard_normal(A.n)).to(dev, dt)
        window = lambda: apply(v)
        _device_time_top(window, _wall_ms(window), card, top=4)


def _eig_card_vs_cpu(dev, card):
    """Each route of EIG_SMALL in fp64 through ``api.eigs`` on the card and
    on the CPU: values within EIG_AGREE, matvecs and restarts (LOBPCG's
    iterations) equal.  LOBPCG starts both from the same host draws (its
    default draws on the solve's device, whose stream is not the host's)."""
    from conjugategradient_tpu_torch.solvers.lobpcg import _draw

    out = {}
    for route, (kind, kw) in EIG_SMALL.items():
        A = (generators.poisson_system((31, 31)).A if kind == "poisson"
             else generators.convection_diffusion_matrix((16, 16), eps=CD_EPS))
        if kind == "poisson":
            kw = dict(kw, X0=_draw(A.n, kw["k"], SEED), P0=_draw(A.n, kw["k"], SEED + 1))
        rc = api.eigs(A, dtype=np.float64, device="cpu", **kw)
        rg = api.eigs(A, dtype=np.float64, device=dev, **kw)
        dv = float(np.max(np.abs(rg.values - rc.values) / np.abs(rc.values)))
        _require(rg.converged and rc.converged, f"card vs CPU {route}: converged "
                 f"{rg.converged} / {rc.converged}")
        _require((rg.matvecs, rg.restarts) == (rc.matvecs, rc.restarts) and dv <= EIG_AGREE,
                 f"card vs CPU {route}: matvecs, restarts {rg.matvecs, rg.restarts} / "
                 f"{rc.matvecs, rc.restarts}, values differ by {dv:.3e}")
        out[route] = (rg.matvecs, rg.restarts, float(f"{dv:.2e}"), rg.inner_matvecs,
                      rc.inner_matvecs)
    print(f"eigensolvers fp64 small, card against CPU (matvecs, restarts, max rel value diff; "
          f"inner matvecs on the card and the CPU): {out} [{card}]")


def _eig_spmm_times(dev, card):
    """Kernel #5 at LOBPCG's A pass on Poisson EIG_SPMM_GRID (5 diagonals,
    3k = 24 columns), fp32 and fp64: against its twin, cuSPARSE's CSR
    ``A @ X`` and the bound."""
    A_host = generators.poisson_system(EIG_SPMM_GRID).A
    k = 3 * EIG_K
    for dt in (torch.float32, torch.float64):
        A = A_host.device_put(dt, dev)
        X = torch.from_numpy(np.random.default_rng(SEED).standard_normal((k, A.n))).to(dev, dt)
        k_ms = time_ms(lambda: spmm_dia_cuda(A, X), 50)
        p_ms = time_ms(lambda: spmm_dia_ref(A, X), 5)
        err, scale = _max_err(spmm_dia_cuda(A, X), spmm_dia_ref(A, X))
        _require(err <= (KERNEL_REL if dt == torch.float32 else KERNEL_REL64) * scale,
                 f"spmm_dia {EIG_SPMM_GRID} k={k} {TAGS[dt]}: max err {err:.3e} against the twin")
        csr, Xn = dia_csr(A), X.T.contiguous()
        tag = f"spmm_dia Poisson {EIG_SPMM_GRID} 5 diagonals k={k} {TAGS[dt]} (LOBPCG's A pass)"
        lib_ms = _library(tag, lambda: csr @ Xn, spmm_dia_cuda(A, X).T, card, 20)
        nbytes = dia_nnz(A) * A.data.element_size() + 2 * k * A.n * X.element_size()
        bound = bound_ms(nbytes, 2 * k * dia_nnz(A))
        print(f"time {tag}: kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms "
              f"by {bound[1]}, {bound[0] / k_ms:.1%} of it; {len(k_chunks(k))} launches), twin "
              f"{p_ms:.4f} ms, CSR A @ X {lib_ms:.4f} ms, max err {err:.2e} [{card}]")
        del csr, Xn


def _eigensolvers(dev, card, count):
    """The eigensolvers on the card: LOBPCG by the facade, generalized,
    Arnoldi, shift-invert; card against CPU; #5 at LOBPCG's shape."""
    for step in (_lobpcg_facade, _generalized, _arnoldi_routes, _shift_invert):
        t0 = time.perf_counter()
        step(dev, card, count)
        print(f"  {step.__name__.lstrip('_')}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _eig_card_vs_cpu(dev, card)
    _eig_spmm_times(dev, card)
    print(f"  card vs CPU, #5 times: {time.perf_counter() - t0:.1f} s")


# -- the host kit (native) and the batched solves ------------------------------

#: api.solve(method="native") on Poisson MTX_GRID in fp64 to rel_l2
#: NATIVE_TOL, capped (plain CG stalls on systems like the flagship's and
#: would run n iterations: never uncapped here)
NATIVE_TOL = 1e-6
NATIVE_CAP = 2000
#: the CSR whose conversions are timed beside numpy's and held to them bit
#: for bit; the other (HandmadeCL, whose numpy conversions took 22.5 s) is
#: converted by csrkit alone: its COO -> CSR must give the CSR back, its
#: DIA and ELL products the CSR's within NATIVE_PRODUCT_REL (fp64 sums in
#: another order)
NATIVE_NUMPY = "flagship"
NATIVE_PRODUCT_REL = 1e-12
#: batched kernel #4's checks: (label, host DiaMatrix, k values,
#: dtypes); the flagship band (fp32 and fp64, k in 1, 3, 8), the 16^3 x 343
#: chain (split launches), a ragged n
BATCH_KS = (1, 3, 8)
#: the record's shape of the batched kernels: the sweep's (k = 8, fp32)
BATCH_MAIN = "flagship n=207402 band=160"
BATCH_CHAIN_K = 4
BATCH_RAGGED = (5003, 32)
#: the batched sweep: k flagship members (data x (1 + 0.1 j)) in fp32
BATCH_SWEEP_K = 8
#: the batched gradients: k members of the implicit phase's fp64 systems;
#: against the loop of single gradients, relative to the largest entry
BATCH_GRAD_K = 4
BATCH_GRAD_REL = 1e-10


def _same_arrays(tag, got, want, fields):
    for f in fields:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        _require(a.shape == b.shape and np.array_equal(a, b), f"{tag}: {f} differs from numpy's")


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def _native(csrs, card):
    """The host kit (``native``): it must have built (its OpenMP threads and,
    where the compiler refused ``-fopenmp``, why, printed); csrkit's
    COO -> CSR, CSR -> DIA and CSR -> ELL on the NATIVE_NUMPY CSR equal the
    port's numpy conversions exactly, each timed beside the numpy one, and
    on the other CSR give the CSR back and its products
    (NATIVE_PRODUCT_REL); ``api.solve(method="native")`` on Poisson MTX_GRID fp64 takes
    ``oracle.cg``'s count (within 1), its true residual meets the tol."""
    from conjugategradient_tpu_torch import native
    from conjugategradient_tpu_torch.core import formats

    _require(native.available(), "native: the host kit did not build")
    log = _build.host_library_path("csrkit").with_suffix(".log")  # the build without flags
    why = f": {log.read_text()[-600:]!r}" if log.exists() else ""
    print(f"native: csrkit built by {os.environ.get('CXX') or 'g++'}, OpenMP threads "
          f"{native.threads()} (0: built without OpenMP{why}; OMP_NUM_THREADS "
          f"{os.environ.get('OMP_NUM_THREADS')}, os.cpu_count() {os.cpu_count()})")
    for label, csr in csrs:
        coo = csr_to_coo(csr)
        rows = []
        numpy_too = label == NATIVE_NUMPY
        if not numpy_too:
            x = np.random.default_rng(SEED + 52).standard_normal(csr.n)
            y = to_scipy(csr) @ x
        for name, kit, ref, fields in (
                ("coo_to_csr", native.coo_to_csr, formats.coo_to_csr,
                 ("data", "indices", "indptr", "row_ids")),
                ("csr_to_dia", native.csr_to_dia, formats.csr_to_dia, ("data", "offsets")),
                ("csr_to_ell", native.csr_to_ell, formats.csr_to_ell, ("data", "cols"))):
            arg = coo if name == "coo_to_csr" else csr
            got, kit_s = _timed(lambda: kit(arg))
            if numpy_too:
                want, np_s = _timed(lambda: ref(arg))
                _same_arrays(f"native {name} {label}", got, want, fields)
                rows.append(f"{name} {kit_s:.3f} s (numpy {np_s:.3f} s, {np_s / kit_s:.1f}x)")
                del want
            elif name == "coo_to_csr":  # the round trip: the CSR back
                _same_arrays(f"native {name} {label}", got, csr, fields)
                rows.append(f"{name} {kit_s:.3f} s (the CSR back)")
            else:  # the converted product against scipy's CSR product
                err = float(np.abs(oracle.spmv(got, x) - y).max() / np.abs(y).max())
                _require(err <= NATIVE_PRODUCT_REL, f"native {name} {label}: its product is "
                                                    f"{err:.3e} from the CSR's")
                rows.append(f"{name} {kit_s:.3f} s (product {err:.1e} from the CSR's)")
            del got
        same = "; each equal to numpy's" if numpy_too else ""
        print(f"native {label} ({csr.nnz} nnz): {'; '.join(rows)}{same} [host of {card}]")
        del coo
    s = generators.poisson_system(MTX_GRID)
    kw = dict(tol=NATIVE_TOL, norm="rel_l2", max_iteration=NATIVE_CAP)
    res, wall = _timed(lambda: api.solve(s.A, s.b, method="native", **kw))
    ref, o_wall = _timed(lambda: oracle.cg(s.A, s.b, raise_on_divergence=False, **kw))
    tag = f"api.solve(method='native') Poisson {MTX_GRID} fp64 rel_l2 {NATIVE_TOL}"
    _require(res.converged and ref.converged, f"{tag}: converged {res.converged}, oracle "
             f"{ref.converged}")
    _require(abs(res.iterations - ref.iterations) <= 1,
             f"{tag}: {res.iterations} iterations, oracle.cg {ref.iterations}")
    rel = _host_rel_residual(s.A, s.b, res.x)
    _require(rel < NATIVE_TOL, f"{tag}: true fp64 relative residual {rel:.3e}")
    print(f"{tag}: {res.iterations} iterations (oracle.cg {ref.iterations}), true fp64 rel "
          f"residual {rel:.3e}, wall {wall:.3f} s with the CSR conversion (oracle.cg on the DIA "
          f"{o_wall:.3f} s) [host of {card}]")


def _members(A_dev, k):
    """k members of one sparsity on the card: A's legs times (1 + 0.1 j)."""
    scale = 1 + 0.1 * torch.arange(k, device=A_dev.data.device, dtype=A_dev.data.dtype)
    return (A_dev.data[None] * scale[:, None, None]).contiguous()


def _block_diag_csr(data, offsets):
    """The block-diagonal CSR of k DIA members (one cuSPARSE product
    computes every member's A x): built on the card from the first
    member's structure."""
    k, nd, n = data.shape
    csr0 = dia_csr(DiaMatrix(data[0], offsets, (n, n)))
    crow, col = csr0.crow_indices().long(), csr0.col_indices().long()
    nnz = int(crow[-1])
    order = sorted(range(nd), key=lambda q: offsets[q])
    cols = torch.arange(n, device=data.device)[:, None] + torch.tensor(
        [offsets[q] for q in order], device=data.device)[None, :]
    keep = (cols >= 0) & (cols < n)
    vals = torch.cat([data[j][order].T[keep] for j in range(k)])
    crows = torch.cat([crow[:-1] + j * nnz for j in range(k)] + [crow[-1:] + (k - 1) * nnz])
    cidx = torch.cat([col + j * n for j in range(k)])
    return torch.sparse_csr_tensor(crows.int(), cidx.int(), vals, size=(k * n, k * n),
                                   check_invariants=False)


def _batched_kernel_checks(fsys, dev, card, errs, times):
    """Batched kernel #4 (and its fused p.Ap) against its twin and, member
    by member, against ``spmv_dia_cuda`` (``spmv_dot_dia_cuda``) bit for
    bit: the flagship band at k in BATCH_KS in fp32 and fp64, the 16^3 x
    343 chain (split launches) at BATCH_CHAIN_K, a ragged n; each timed
    against its bound (k members' legs, x and y once), k single #4
    launches, the twin and one cuSPARSE product of the members' block-
    diagonal CSR.  ``times`` gets the record's shape (flagship, k = 8,
    fp32)."""
    from conjugategradient_tpu_torch.ops.cuda_dia import (
        spmv_dia_batched_cuda,
        spmv_dia_batched_ref,
        spmv_dot_dia_batched_cuda,
        spmv_dot_dia_batched_ref,
    )

    rng = np.random.default_rng(SEED + 17)
    g = 16
    chain_offs = tuple(sorted({(a * g + b) * g + c for a in range(-3, 4) for b in range(-3, 4)
                               for c in range(-3, 4)}))
    n3 = g ** 3
    chain_data = rng.standard_normal((len(chain_offs), n3))
    i = np.arange(n3)
    for q, o in enumerate(chain_offs):
        chain_data[q, (i + o < 0) | (i + o >= n3)] = 0.0
    cases = [(BATCH_MAIN, fsys.A, BATCH_KS, (torch.float32, torch.float64)),
             (f"16^3 x {len(chain_offs)} chained", DiaMatrix(chain_data, chain_offs, (n3, n3)),
              (BATCH_CHAIN_K,), (torch.float32, torch.float64)),
             (f"ragged n={BATCH_RAGGED[0]} band={BATCH_RAGGED[1]}",
              generators.banded_sin_matrix(*BATCH_RAGGED), (3,), (torch.float32, torch.float64))]
    for label, A_host, ks, dtypes in cases:
        for dt in dtypes:
            A = A_host.device_put(dt, dev)
            rel = KERNEL_REL64 if dt == torch.float64 else KERNEL_REL
            plan = cuda_dia.dia_plan(A.n, A.ndiags)
            for k in ks:
                tag = f"batched spmv_dia {label} {TAGS[dt]} k={k}"
                data = _members(A, k)
                x = torch.from_numpy(rng.standard_normal((k, A.n))).to(dev, dt)
                y = spmv_dia_batched_cuda(data, A.offsets, x)
                yf, dots = spmv_dot_dia_batched_cuda(data, A.offsets, x)
                ref, ref_dots = spmv_dot_dia_batched_ref(data, A.offsets, x)
                torch.cuda.synchronize()
                err, scale = _max_err(y, ref)
                _require(err <= rel * scale, f"{tag}: max err {err:.3e} > {rel}*{scale:.3e}")
                dot_err = float((dots - ref_dots).abs().max())
                dot_scale = float((x.abs() * ref.abs()).sum(1).max())
                _require(torch.equal(yf, y) and dot_err <= rel * dot_scale,
                         f"{tag}: fused y or p.Ap (err {dot_err:.3e}) off")
                for j in range(k):
                    Aj = DiaMatrix(data[j], A.offsets, A.shape)
                    yj, dj = spmv_dot_dia_cuda(Aj, x[j])
                    _require(torch.equal(y[j], spmv_dia_cuda(Aj, x[j])) and torch.equal(yf[j], yj)
                             and torch.equal(dots[j], dj),
                             f"{tag}: member {j} differs from the single kernel's")
                name = "spmv_dia_batched"
                if dt == torch.float32:
                    errs[name] = max(errs[name], err)
                    errs["spmv_dot_dia_batched"] = max(errs["spmv_dot_dia_batched"], err,
                                                       dot_err / dot_scale * scale)
                short = A.n * A.ndiags < 2_000_000
                timer = graph_ms if short else time_ms
                reps = 200
                singles = [DiaMatrix(data[j], A.offsets, A.shape) for j in range(k)]
                # in turns (batched, fused, k singles, twice): a first
                # window after the host's checks may run at a lower clock
                runs = [timer(fn, reps) for _ in range(2) for fn in (
                    lambda: spmv_dia_batched_cuda(data, A.offsets, x),
                    lambda: spmv_dot_dia_batched_cuda(data, A.offsets, x),
                    lambda: [spmv_dia_cuda(singles[j], x[j]) for j in range(k)])]
                k_ms, f_ms, s_ms = runs[3:]
                p_ms = time_ms(lambda: spmv_dia_batched_ref(data, A.offsets, x), 3)
                pf_ms = time_ms(lambda: spmv_dot_dia_batched_ref(data, A.offsets, x), 3)
                bd = _block_diag_csr(data, A.offsets)
                xs = x.reshape(-1)
                lib_ms = _library(tag, lambda: bd @ xs, y.reshape(-1), card, reps)
                del bd
                nnz = dia_nnz(A)
                esz = data.element_size()
                nbytes = k * (nnz * esz + 2 * A.n * esz)
                bound = bound_ms(nbytes, 2 * k * nnz)
                bound_f = bound_ms(nbytes, 2 * k * nnz + 2 * k * A.n)
                key = ("spmv_dia_batched", label, TAGS[dt], k)
                times[key] = (k_ms, p_ms, lib_ms, bound)
                times[("spmv_dot_dia_batched",) + key[1:]] = (f_ms, pf_ms, lib_ms, bound_f)
                print(f"{tag} (split {plan.split}, {len(plan.groups)} launch"
                      f"{'es' if len(plan.groups) > 1 else ''}): members bit-equal to "
                      f"spmv_dia_cuda / spmv_dot_dia_cuda, max|kernel-twin| {err:.3e} (max|twin| "
                      f"{scale:.3e}), p.Ap err {dot_err:.3e}; kernel {k_ms:.4f} ms"
                      f"{' (graph)' if short else ''} ({nbytes / 1e6:.1f} MB, bound "
                      f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / k_ms:.1%} of it), fused "
                      f"{f_ms:.4f} ms, {k} single #4 launches {s_ms:.4f} ms (the first turn "
                      f"{runs[0]:.4f} / {runs[1]:.4f} / {runs[2]:.4f}), twin {p_ms:.4f} ms "
                      f"(fused {pf_ms:.4f}), block-diagonal CSR {lib_ms:.4f} ms [{card}]")
                del data, x, y, yf, ref, singles
            del A


def _batched_sweep(fsys, dev, card, count):
    """``cg_solve_batched`` on BATCH_SWEEP_K flagship members (data x (1 +
    0.1 j)) in fp32 to rel_l2 TOL: each member converged with
    ``cg_solve``'s count on that member and a true fp64 relative residual
    within TRUE_REL; one fused batched #4 launch an iteration and one
    batched SpMV for the initial residual; the warm wall beside the k
    sequential ``cg_solve``s, and the busy share."""
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_batched

    k = BATCH_SWEEP_K
    A = fsys.A.device_put(torch.float32, dev)
    data = _members(A, k)
    b = torch.from_numpy(fsys.b.astype(np.float32)).to(dev)
    B = b.expand(k, -1).contiguous()
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    tag = f"cg_solve_batched flagship fp32 k={k} (data x (1 + 0.1 j)) rel_l2 {TOL}"
    _reset_counts()
    res = cg_solve_batched(data, A.offsets, A.shape, B, policy=pol)
    torch.cuda.synchronize()
    got = launch_counts()
    its = res.iterations.tolist()
    _require(bool(res.converged.all()), f"{tag}: converged {res.converged.tolist()}, its {its}")
    _require(got["spmv_dot_dia_batched"] == max(its) and got["spmv_dia_batched"] == 1
             and got["spmv_dia"] == 0,
             f"{tag}: launches {got}, the recurrence implies {max(its)} fused + 1")
    count(f"batched: {tag}", {"spmv_dia_batched": got["spmv_dia_batched"],
                              "spmv_dot_dia_batched": got["spmv_dot_dia_batched"]})
    singles = [DiaMatrix(data[j], A.offsets, A.shape) for j in range(k)]
    single_its = [cg_solve(singles[j], b, policy=pol).iterations for j in range(k)]
    _require(single_its == its, f"{tag}: iterations {its}, cg_solve per member {single_its}")
    rels = []
    for j in range(k):
        Aj = DiaMatrix(fsys.A.data * (1 + 0.1 * j), fsys.A.offsets, fsys.A.shape)
        rels.append(_host_rel_residual(Aj, fsys.b, res.x[j].double().cpu().numpy()))
    _require(max(rels) <= TRUE_REL, f"{tag}: true fp64 relative residuals {rels}")
    batched = lambda: cg_solve_batched(data, A.offsets, A.shape, B, policy=pol)
    loop = lambda: [cg_solve(singles[j], b, policy=pol) for j in range(k)]
    w_b, w_l = _wall_median_ms(batched), _wall_median_ms(loop)
    print(f"{tag}: iterations {its} (cg_solve per member the same), true fp64 rel residuals max "
          f"{max(rels):.3e}; launches {got['spmv_dot_dia_batched']} fused batched + "
          f"{got['spmv_dia_batched']} batched; warm wall {_fmt_wall(w_b)} against {k} sequential "
          f"cg_solve {_fmt_wall(w_l)} ({w_l[0] / w_b[0]:.2f}x) [{card}]")
    _device_time_top(batched, w_b[0], card, top=5)


def _batched_gradients(fsys, dev, card, count):
    """``torch.func.vmap(torch.func.grad(loss))`` over ``cg_solve_implicit``
    on BATCH_GRAD_K members of the implicit phase's fp64 flagship, and over
    ``bicgstab_solve_implicit`` on members of its nonsymmetric twin: each
    member's gradients within BATCH_GRAD_REL of a loop of single gradients;
    the forward and adjoint solves on the batched #4 (no single #4
    launch)."""
    from conjugategradient_tpu_torch.solvers.diff import (
        bicgstab_solve_implicit,
        cg_solve_implicit,
    )

    k = BATCH_GRAD_K
    rng = np.random.default_rng(SEED + 18)
    twin = generators.nonsymmetric_banded_system(TWIN_N, TWIN_BAND)
    for label, fn, s, pol in (
            ("cg_solve_implicit flagship", cg_solve_implicit, fsys,
             ConvergencePolicy(tol=IMPLICIT_TOL, norm="rel_l2", max_iteration=2000)),
            ("bicgstab_solve_implicit twin", bicgstab_solve_implicit, twin,
             ConvergencePolicy(tol=IMPLICIT_TOL, norm="rel_l2"))):
        A = s.A.device_put(torch.float64, dev)
        offs, shape = A.offsets, A.shape
        datas = _members(A, k)
        bs = torch.from_numpy(np.stack([s.b] * k)).to(dev)
        w = torch.from_numpy(rng.standard_normal(A.n)).to(dev)
        loss = lambda d, b: torch.dot(w, fn(d, b, offs, shape, pol))
        tag = f"vmap(grad) {label} fp64 k={k}"
        _reset_counts()
        t0 = time.perf_counter()
        gd, gb = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(datas, bs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = launch_counts()
        _require(got["spmv_dia"] == 0 and got["spmm_dia"] == 0 and got["spmv_dia_batched"] > 0,
                 f"{tag}: launches {got}")
        count(f"batched: {tag}", {"spmv_dia_batched": got["spmv_dia_batched"],
                                  "spmv_dot_dia_batched": got["spmv_dot_dia_batched"]},
              fp32=False)
        t0 = time.perf_counter()
        worst = 0.0
        for j in range(k):
            d1, b1 = torch.func.grad(loss, argnums=(0, 1))(datas[j], bs[j])
            for got_g, want in ((gd[j], d1), (gb[j], b1)):
                worst = max(worst, float((got_g - want).abs().max() / want.abs().max()))
        loop = time.perf_counter() - t0
        _require(worst <= BATCH_GRAD_REL, f"{tag}: gradients {worst:.3e} from the loop's")
        print(f"{tag}: gradients within {worst:.2e} of {k} single gradients; launches batched "
              f"{got['spmv_dia_batched']} + fused {got['spmv_dot_dia_batched']}; wall {wall:.3f} s "
              f"(the loop {loop:.3f} s) [{card}]")


def _native_and_batched(csrs, fsys, dev, card, errs, times, count):
    """The host kit, batched #4 against its twin and the single kernel, the
    batched CG sweep and the batched gradients."""
    for step, args in ((_native, (csrs, card)),
                       (_batched_kernel_checks, (fsys, dev, card, errs, times)),
                       (_batched_sweep, (fsys, dev, card, count)),
                       (_batched_gradients, (fsys, dev, card, count))):
        t0 = time.perf_counter()
        step(*args)
        print(f"  {step.__name__.lstrip('_')}: {time.perf_counter() - t0:.1f} s")


#: the parallel phase: the flagship row-block-sharded over PAR_SHARDS shards
#: of one card (and over 1), by every variant of sharded CG (cacg at s =
#: PAR_S); a sharded count against the single-device count: a psum adds
#: the shards' partials in another order than one dot
PAR_SHARDS = 4
PAR_S = 4
PAR_VARIANTS = ("cg", "cg1", "pipelined", "cacg")
PAR_COUNT_SPREAD = 2
#: every policy of the phase stops here, so that a stall fails in seconds
PAR_CAP = 2000
#: fp64 CA-CG's policy, apart from the workload's: the s-step loop monitors
#: the true residual (its residual replacement), which stalls at 1.8e-8 to
#: 6.0e-8 on the flagship in fp64 (FLAGSHIP_CG_TRUE), above the workload's
#: 1e-8, so it ends at FLAGSHIP_CG_TRUE; and without the workload's 200
#: minimum iterations, which carry the s-step recurrence past convergence
#: until its monomial basis breaks down (on the CPU at a 4094-row cut of the
#: flagship: residual 2.8e146 after 756 iterations).  Capped, so that a
#: stall fails in seconds
PAR_CACG64 = ConvergencePolicy(tol=FLAGSHIP_CG_TRUE, norm="l2", max_iteration=PAR_CAP)
#: fp64 pipelined CG's, from x0 = 0: its u and w recurrences drift from
#: M r and A u, so it keeps its accuracy neither past convergence (the
#: workload's 200 minimum iterations) nor from the workload's x0 (i/100, up
#: to 2074), whose rounding its recurrences carry: the phase prints that
#: solve, capped at PAR_PIPE_X0_CAP iterations, beside the held one.  The
#: JAX package's sharded pipelined CG and a textbook numpy one stall there
#: too (tests/pipelined_witness.py, on the CPU).  rel_l2 1e-12, not 1e-10:
#: at 1e-10 the true ||r||_2 (1.2e-7) misses FLAGSHIP_CG_TRUE
PAR_PIPE64 = ConvergencePolicy(tol=1e-12, norm="rel_l2", max_iteration=PAR_CAP)
PAR_PIPE_X0_CAP = 300
#: max |x_4 - x_1| / max |x_1| between the 4-shard and the 1-shard solution
#: of one variant: fp64 1e-9 (measured up to 5.3e-12 on the card, cg1),
#: fp32 TRUE_REL (measured up to 8.6e-7, pipelined)
PAR_X_AGREE = {torch.float64: 1e-9, torch.float32: TRUE_REL}


def _k4_launches() -> int:
    """Kernel #4's launches since the last reset, plain and fused."""
    return spmv_dia_cuda.launches + spmv_dot_dia_cuda.launches


def _par_want(variant, num, its, outer) -> int:
    """Kernel #4's launches the recurrence implies: one a shard per product
    (cg: the initial residual and one fused product an iteration; cg1 and
    pipelined: two at the start and one an iteration; cacg: the initial
    residual and 2s a shard per outer step)."""
    if variant == "cg":
        return num * (its + 1)
    if variant in ("cg1", "pipelined"):
        return num * (its + 2)
    return num * (1 + 2 * PAR_S * outer)


def _par_profile(tag, fn, wall_ms, card):
    """One profiled run of ``fn``: the device busy share of ``wall_ms`` and
    the top kernels; no cuSPARSE kernel may run on the DIA path."""
    _, prof_ms, rows = _profile_rows(fn)
    total_ms = sum(r[0] for r in rows) / 1e3
    names = [k for _, _, k in rows]
    _require(not any("csr" in k.lower() or "cusparse" in k.lower() for k in names),
             f"{tag}: a cuSPARSE kernel ran on the DIA path: {names}")
    print(f"profile {tag}: device time {total_ms:.3f} ms in {sum(r[1] for r in rows)} device ops, "
          f"busy {total_ms / wall_ms:.1%} of the warm wall {wall_ms:.3f} ms (profiled wall "
          f"{prof_ms:.3f} ms); top {[(k[:48], round(us / 1e3, 3), n) for us, n, k in rows[:5]]} "
          f"[{card}]")
    return total_ms / wall_ms


def _pad_csr(csr: CsrMatrix, mult: int) -> CsrMatrix:
    """``csr`` with identity rows appended up to a multiple of ``mult`` (the
    rows ``core.partition.pad_system`` appends to a DIA)."""
    n = csr.n
    extra = -(-n // mult) * mult - n
    if not extra:
        return csr
    rows = np.arange(n, n + extra, dtype=np.int32)
    return CsrMatrix(np.concatenate([csr.data, np.ones(extra, csr.data.dtype)]),
                     np.concatenate([csr.indices, rows]),
                     np.concatenate([csr.indptr, csr.indptr[-1] + np.arange(1, extra + 1)])
                     .astype(np.int32),
                     np.concatenate([csr.row_ids, rows]), (n + extra, n + extra))


def _par_assembly(fsys, mesh, dev):
    """``make_distributed_system`` of the flagship on the mesh: every shard's
    block equal to ``pad_system`` of the full build, bit for bit."""
    t0 = time.perf_counter()
    A, b, x0, n = make_distributed_system(FLAGSHIP, mesh)
    torch.cuda.synchronize()
    built = time.perf_counter() - t0
    padded, _ = pad_system(fsys, mesh.size)
    n_local = padded.n // mesh.size
    for i in range(mesh.size):
        rows = slice(i * n_local, (i + 1) * n_local)
        for got, want, what in ((A.data.parts[i], padded.A.data[:, rows], "A"),
                                (b.parts[i], padded.b[rows], "b"), (x0.parts[i], padded.x0[rows], "x0")):
            _require(got.device == dev and torch.equal(got.cpu(), torch.from_numpy(want)),
                     f"make_distributed_system: shard {i}'s {what} differs from pad_system's")
    print(f"make_distributed_system({FLAGSHIP!r}) on {mesh.size} shards of {dev}: n {n} padded to "
          f"{A.n}, {n_local} rows a shard, {A.ndiags} diagonals, every block bit-equal to "
          f"pad_system of the full build; {built:.3f} s")
    return A, b, x0, padded


def _par_variants(fsys, sharded, dev, card, count, witness=None):
    """Every variant on PAR_SHARDS shards and on 1, fp64 at the workload's
    policy and x0 (PAR_PIPE64 from x0 = 0 for pipelined, PAR_CACG64 for
    cacg) and fp32 at rel_l2 TOL from x0 = 0 (as the smoke's other fp32
    flagship routes):
    counts within PAR_COUNT_SPREAD of the
    single-device solver's (cg_solve; cacg_solve for cacg), kernel #4's
    launches as the recurrence implies, the true residual within the
    bounds the smoke holds plain CG to, the shard counts' x against each
    other.  Returns the meshes and the fp64 cg solve's (iterations, x) on
    PAR_SHARDS shards (the multi-process phase's reference)."""
    from conjugategradient_tpu_torch.solvers.cacg import cacg_solve

    A4, b4, x04, padded = sharded
    n = fsys.n
    pol32 = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=PAR_CAP)
    pol64 = dataclasses.replace(WORKLOADS[FLAGSHIP].policy, max_iteration=PAR_CAP)
    pols = {torch.float64: dict(cg=pol64, cg1=pol64, pipelined=PAR_PIPE64, cacg=PAR_CACG64),
            torch.float32: dict.fromkeys(PAR_VARIANTS, pol32)}
    meshes = {PAR_SHARDS: make_mesh(PAR_SHARDS, devices=[dev] * PAR_SHARDS),
              1: make_mesh(1, devices=[dev])}
    ref = {}  # (dtype, variant) -> the single-device count at the variant's policy
    # the workload's x0 where the policy is the workload's (or cacg's), else 0
    from_x0 = lambda dt, variant: dt == torch.float64 and variant != "pipelined"  # noqa: E731
    for dt, by_variant in pols.items():
        A_dev = fsys.A.device_put(dt, dev)
        b_dev = torch.from_numpy(fsys.b).to(dev, dt)
        for variant, pol in by_variant.items():
            x0_dev = torch.from_numpy(fsys.x0 if from_x0(dt, variant) else 0 * fsys.x0).to(dev, dt)
            single = (cacg_solve(A_dev, b_dev, x0_dev, pol, s=PAR_S) if variant == "cacg"
                      else cg_solve(A_dev, b_dev, x0_dev, pol))
            _require(single.converged, f"single device {variant} {TAGS[dt]}: {single.iterations}")
            ref[(dt, variant)] = single.iterations
    t0 = time.perf_counter()
    n_cg = ref[(torch.float64, "cg")]
    reused = witness is not None and witness[0] == n_cg  # the storage phase's, at its count
    witness = witness[1] if reused else _textbook_cg_true_l2(dia_to_csr(fsys.A), fsys, n_cg)
    print(f"parallel: single-device counts (cg_solve; cacg_solve s={PAR_S} for cacg) "
          f"{ {f'{v} {TAGS[dt]}': its for (dt, v), its in ref.items()} }; scipy's textbook CG "
          f"witness at {n_cg} iterations {witness:.3e} ("
          f"{'the storage phase' if reused else f'{time.perf_counter() - t0:.1f} s'})")
    xs = {}
    for dt, by_variant in pols.items():
        for num, mesh in meshes.items():
            for variant, pol in by_variant.items():
                tag = f"sharded_cg {FLAGSHIP} {num} shard(s) {variant} {TAGS[dt]}"
                x0 = from_x0(dt, variant)
                if num == PAR_SHARDS:  # the per-block assembly, padded
                    args = (A4, b4, x04 if x0 else None)
                else:
                    args = (fsys.A, fsys.b, fsys.x0 if x0 else None)
                _reset_counts()
                t0 = time.perf_counter()
                res = sharded_cg_solve(*args, pol, mesh, dtype=dt, variant=variant, s=PAR_S)
                outer = res.outer_steps if variant == "cacg" else 0
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                x = res.x[:n].cpu().numpy().astype(np.float64)
                want_its = ref[(dt, variant)]
                _require(res.converged and abs(res.iterations - want_its) <= PAR_COUNT_SPREAD,
                         f"{tag}: converged {res.converged} in {res.iterations} iterations, the "
                         f"single-device solver {want_its}")
                _require(res.x.device == dev and bool(np.isfinite(x).all()), f"{tag}: bad x")
                if num == PAR_SHARDS:
                    _require(not bool(res.x[n:].any()), f"{tag}: the padded rows of x are not 0")
                k4 = _k4_launches()
                want = _par_want(variant, num, res.iterations, outer)
                _require(k4 == want, f"{tag}: {k4} kernel #4 launches, the recurrence implies "
                         f"{want}")
                if dt == torch.float64:
                    true = _true_l2(fsys.A, fsys.b, x)
                    _require(true <= FLAGSHIP_CG_TRUE and true <= CG_ORDER_SPREAD * witness,
                             f"{tag}: true ||r||_2 {true:.3e} (bound {FLAGSHIP_CG_TRUE}, "
                             f"{CG_ORDER_SPREAD}x the witness {witness:.3e})")
                    what = f"true fp64 ||r||_2 {true:.3e} ({true / witness:.3f}x the witness)"
                else:
                    true = _host_rel_residual(fsys.A, fsys.b, x)
                    _require(true <= TRUE_REL, f"{tag}: true fp64 relative residual {true:.3e}")
                    what = f"true fp64 rel residual {true:.3e}"
                xs[(dt, num, variant)] = x
                if (dt, num, variant) == (torch.float64, PAR_SHARDS, "cg"):
                    cg64 = (res.iterations, res.x.cpu())
                count(tag, {"spmv_dia": k4}, fp32=dt == torch.float32)
                print(f"{tag}: {res.iterations} iterations (single device {want_its}), {what}, "
                      f"kernel #4 {k4} launches = the recurrence's {want}"
                      f"{f' ({outer} outer steps)' if variant == 'cacg' else ''}, wall "
                      f"{wall * 1e3:.3f} ms [{card}]")
    pol = dataclasses.replace(pol64, min_iteration=0, max_iteration=PAR_PIPE_X0_CAP)
    res = sharded_cg_solve(A4, b4, x04, pol, meshes[PAR_SHARDS], variant="pipelined")
    x = res.x[:n].cpu().numpy()
    print(f"sharded_cg pipelined fp64 from the workload's x0 at its tolerance (not held): "
          f"converged {res.converged} in {res.iterations} iterations, recurrence residual "
          f"{float(res.residual):.3e}, true ||r||_2 {_true_l2(fsys.A, fsys.b, x):.3e} [{card}]")
    for (dt, num, variant), x in xs.items():
        if num == PAR_SHARDS:
            x1 = xs[(dt, 1, variant)]
            dx = np.abs(x - x1).max() / np.abs(x1).max()
            _require(dx <= PAR_X_AGREE[dt], f"sharded_cg {variant} {TAGS[dt]}: {PAR_SHARDS} shards "
                     f"against 1, max |dx| / max |x| {dx:.3e} > {PAR_X_AGREE[dt]}")
            print(f"sharded_cg {variant} {TAGS[dt]}: {PAR_SHARDS} shards against 1, max |dx| / "
                  f"max |x| {dx:.3e} <= {PAR_X_AGREE[dt]}")
    return meshes, cg64


def _par_times(fsys, sharded, meshes, dev, card):
    """Warm medians of WALL_REPS of the 4-shard, 1-shard and cg_solve
    solves of the flagship (the cg variant), fp32 at rel_l2 TOL from x0 = 0
    and fp64 at the workload's policy, the fp32 4-shard one with its device
    busy share (one profiled run; cut from a profile of each, to make room
    for the multi-process phase); halo bytes an iteration."""
    A4, b4, x04, _ = sharded
    for dt, pol in ((torch.float32, ConvergencePolicy(tol=TOL, norm="rel_l2")),
                    (torch.float64, WORKLOADS[FLAGSHIP].policy)):
        A_dev = fsys.A.device_put(dt, dev)
        b_dev = torch.from_numpy(fsys.b).to(dev, dt)
        x0_dev = torch.from_numpy(fsys.x0).to(dev, dt)
        data4 = Shards.map(lambda t: t.to(dt), A4.data)
        b4d, x04d = Shards.map(lambda t: t.to(dt), b4), Shards.map(lambda t: t.to(dt), x04)
        if dt == torch.float32:  # from x0 = 0, as the fp32 solves above
            x0_dev, x04d = torch.zeros_like(x0_dev), Shards.map(torch.zeros_like, x04d)
        solve4 = make_sharded_cg(A4, meshes[PAR_SHARDS], pol)
        solve1 = make_sharded_cg(fsys.A, meshes[1], pol)
        data1 = Shards([A_dev.data], meshes[1])
        b1, x01 = Shards([b_dev], meshes[1]), Shards([x0_dev], meshes[1])
        runs = {f"{PAR_SHARDS} shards": lambda: solve4(data4, b4d, x04d),
                "1 shard": lambda: solve1(data1, b1, x01),
                "cg_solve": lambda: cg_solve(A_dev, b_dev, x0_dev, pol)}
        its = {k: fn().iterations for k, fn in runs.items()}
        for k, fn in runs.items():
            walls = _wall_median_ms(fn)
            busy = "" if (k, dt) != (f"{PAR_SHARDS} shards", torch.float32) else (
                f", device busy {_par_profile(f'flagship {k} {TAGS[dt]}', fn, walls[0], card):.1%}")
            print(f"time flagship {k} {TAGS[dt]} ({its[k]} iterations): warm wall "
                  f"{_fmt_wall(walls)}, {walls[0] / its[k]:.4f} ms an iteration{busy} [{card}]")
        _par_shard_kernel(data4, A4.offsets, dev, card)
        hb = exchange_bytes(A4.offsets, A4.n, PAR_SHARDS, dt.itemsize)
        print(f"halo bytes {TAGS[dt]}: {hb} bytes an iteration between {PAR_SHARDS} shards "
              f"({hb // (2 * PAR_SHARDS * dt.itemsize)} rows each way a shard), two psums an "
              f"iteration (cg) [{card}]")
    print(f"parallel: {PAR_SHARDS} shards on one card measure what sharding costs (halo copies, "
          f"psums on one device, {PAR_SHARDS}x the launches of smaller products), not multi-GPU "
          f"speed")


def _par_shard_kernel(data4, offsets, dev, card):
    """Kernel #4's fused form on one shard's extended DIA (its rows with
    zero halo rows, as ``parallel.halo.HaloDia`` launches it), timed
    against its bound, its twin and cuSPARSE's product of the same
    matrix."""
    h = max(abs(o) for o in offsets)
    ext = extend_rows(data4.parts[1], h)
    L = ext.shape[1]
    A = DiaMatrix(ext, tuple(offsets), (L, L))
    rng = np.random.default_rng(SEED + 18)
    p = torch.from_numpy(rng.standard_normal(L)).to(dev, ext.dtype)
    y, dot = spmv_dot_dia_cuda(A, p)
    y_ref, dot_ref = spmv_dot_dia_ref(A, p)
    rel = KERNEL_REL64 if ext.dtype == torch.float64 else KERNEL_REL
    err, scale = _max_err(y, y_ref)
    _require(err <= rel * scale, f"shard #4: max err {err:.3e} against the twin")
    # the fused dot (the partial p.Ap of every sharded cg alpha) sums its
    # blocks' partials in its own order: bounded against sum |p * y|
    dot_err = abs(float(dot) - float(dot_ref))
    dot_scale = float((p * y_ref).abs().sum())
    _require(dot_err <= rel * dot_scale,
             f"shard #4: p.Ap {float(dot)!r} against the twin's {float(dot_ref)!r}, err "
             f"{dot_err:.3e} > {rel} x sum|p*y| {dot_scale:.3e}")
    k_ms = time_ms(lambda: spmv_dot_dia_cuda(A, p), 200)
    t_ms = time_ms(lambda: spmv_dot_dia_ref(A, p), 5)
    csr = dia_csr(A)
    lib_ms = _library(f"spmv_dia one shard {TAGS[ext.dtype]}", lambda: csr @ p, y, card, 200)
    nbytes = dia_nnz(A) * ext.element_size() + 2 * L * p.element_size()
    bound = bound_ms(nbytes, 2 * dia_nnz(A))
    print(f"time spmv_dot_dia on one of {PAR_SHARDS} shards' extended DIA ({L} rows, "
          f"{A.ndiags} diagonals) {TAGS[ext.dtype]}: y max err {err:.3e}, p.Ap err {dot_err:.3e} "
          f"(of sum|p*y| {dot_scale:.3e}); kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; "
          f"bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / k_ms:.1%} of it), twin {t_ms:.4f} "
          f"ms, CSR {lib_ms:.4f} ms [{card}]")


def _par_facade(fsys, sharded, meshes, dev, card, count):
    """api.solve(..., mesh=) by jacobi_cg, cacg and jacobi_cacg on the padded
    flagship in fp32 from x0 = 0: the single-device facade's count within
    PAR_COUNT_SPREAD, the true residual within TRUE_REL."""
    padded = sharded[3]
    kw = dict(tol=TOL, norm="rel_l2", dtype=np.float32)
    for method in ("jacobi_cg", "cacg", "jacobi_cacg"):
        tag = f"api.solve(method={method!r}, mesh={PAR_SHARDS} shards) flagship fp32"
        single = api.solve(fsys.A, fsys.b, method=method, device=dev, **kw)
        _reset_counts()
        res = api.solve(padded.A, padded.b, method=method, mesh=meshes[PAR_SHARDS], **kw)
        torch.cuda.synchronize()
        k4 = _k4_launches()
        rel = _host_rel_residual(fsys.A, fsys.b, res.x[:fsys.n].cpu().numpy().astype(np.float64))
        _require(res.converged and abs(res.iterations - single.iterations) <= PAR_COUNT_SPREAD
                 and rel <= TRUE_REL, f"{tag}: converged {res.converged} in {res.iterations} "
                 f"(single device {single.iterations}), true rel {rel:.3e}")
        _require(k4 > 0 and k4 % PAR_SHARDS == 0, f"{tag}: {k4} kernel #4 launches")
        count(tag, {"spmv_dia": k4})
        print(f"{tag}: {res.iterations} iterations (single device {single.iterations}), true fp64 "
              f"rel residual {rel:.3e}, kernel #4 {k4} launches [{card}]")


def _par_deflation(meshes, dev, card, count):
    """Sharded def-CG on the outlier system of the deflation phase (padded,
    the deflation's basis padded with zero rows) in fp32: the single-device
    def-CG count within PAR_COUNT_SPREAD."""
    from conjugategradient_tpu_torch.solvers.deflation import deflated_cg_solve, make_deflation

    s = generators.outlier_system(TWIN_N, band=OUTLIER_BAND, n_outliers=OUTLIERS,
                                  scale=OUTLIER_SCALE)
    d = make_deflation(s.A, k=DEFL_K, device=dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=PLAIN_CAP)
    single = deflated_cg_solve(s.A.device_put(torch.float32, dev),
                               torch.from_numpy(s.b.astype(np.float32)).to(dev), policy=pol,
                               deflation=d)
    padded, n = pad_system(s, PAR_SHARDS)
    extra = padded.n - n
    d_pad = dataclasses.replace(d, W=F.pad(d.W, (0, 0, 0, extra)), AW=F.pad(d.AW, (0, 0, 0, extra)))
    tag = f"sharded def-CG outlier n {n} k={DEFL_K} on {PAR_SHARDS} shards fp32"
    _reset_counts()
    res = sharded_cg_solve(padded.A, padded.b, policy=pol, mesh=meshes[PAR_SHARDS],
                           dtype=np.float32, deflation=d_pad)
    torch.cuda.synchronize()
    k4 = _k4_launches()
    rel = _host_rel_residual(s.A, s.b, res.x[:n].cpu().numpy().astype(np.float64))
    _require(res.converged and abs(res.iterations - single.iterations) <= PAR_COUNT_SPREAD
             and rel <= TRUE_REL, f"{tag}: converged {res.converged} in {res.iterations} "
             f"(single device {single.iterations}), true rel {rel:.3e}")
    want = PAR_SHARDS * (res.iterations + 3)
    _require(k4 == want, f"{tag}: {k4} kernel #4 launches, the recurrence implies {want}")
    count(tag, {"spmv_dia": k4})
    print(f"{tag}: {res.iterations} iterations (single-device def-CG {single.iterations}), true "
          f"fp64 rel residual {rel:.3e}, kernel #4 {k4} launches = {PAR_SHARDS} x (iterations + "
          f"3) [{card}]")


def _par_general(csrs, fsys, meshes, dev, card):
    """sharded_cg_solve_general on the flagship as CSR and HandmadeCL as ELL
    (each padded to the shard count), fp64 at each workload's policy: the
    hops, the route, the true residual within the workload's bound."""
    hw = WORKLOADS[HANDMADE]
    hsys = hw.build(dtype=np.float64)
    fpol = WORKLOADS[FLAGSHIP].policy
    for label, csr, s, pol, ell in (("flagship CSR", csrs["flagship"], fsys, fpol, False),
                                    ("HandmadeCL ELL", csrs["HandmadeCL"], hsys, hw.policy, True)):
        t0 = time.perf_counter()
        A = _pad_csr(csr, PAR_SHARDS)
        if ell:
            A = csr_to_ell(A)
        extra = A.n - s.n
        b = np.concatenate([s.b, np.zeros(extra)])
        x0 = np.concatenate([s.x0, np.zeros(extra)])
        solve, inputs = make_sharded_cg_general(A, meshes[PAR_SHARDS], pol)
        setup = time.perf_counter() - t0
        tag = f"sharded_cg_solve_general {label} (n {A.n}) on {PAR_SHARDS} shards fp64"
        _reset_counts()
        t0 = time.perf_counter()
        res = solve(*inputs, b, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        _require(_k4_launches() == 0, f"{tag}: launched kernel #4")
        x = res.x[:s.n].cpu().numpy()
        r = s.b - oracle.spmv(s.A, x)
        if pol.norm == "linf":
            true, bound = float(np.abs(r).max()), pol.tol
        else:
            true, bound = float(np.linalg.norm(r)), FLAGSHIP_CG_TRUE
        _require(res.converged and true < bound, f"{tag}: converged {res.converged} in "
                 f"{res.iterations}, true {pol.norm} residual {true:.3e} (bound {bound})")
        print(f"{tag}: hops {solve.hops}, {solve.route}; {res.iterations} iterations, true "
              f"{pol.norm} residual {true:.3e}; setup {setup:.3f} s, solve {wall * 1e3:.3f} ms "
              f"(cuSPARSE / gather products, no kernel of the port) [{card}]")


def _parallel(csrs, fsys, dev, card, count, witness=None):
    """The row-block-sharded CG on one card: the per-block assembly, every
    variant on PAR_SHARDS shards and on 1, the warm times, the facade's
    mesh routes, sharded def-CG, the CSR/ELL solver; each step's seconds.
    Returns the fp64 cg solve's (iterations, x) on PAR_SHARDS shards."""
    mesh = make_mesh(PAR_SHARDS, devices=[dev] * PAR_SHARDS)
    t0 = time.perf_counter()
    sharded = _par_assembly(fsys, mesh, dev)
    print(f"  assembly: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    meshes, cg64 = _par_variants(fsys, sharded, dev, card, count, witness)
    print(f"  variants: {time.perf_counter() - t0:.1f} s")
    for step, args in ((_par_times, (fsys, sharded, meshes, dev, card)),
                       (_par_facade, (fsys, sharded, meshes, dev, card, count)),
                       (_par_deflation, (meshes, dev, card, count)),
                       (_par_general, (dict(csrs), fsys, meshes, dev, card))):
        t0 = time.perf_counter()
        step(*args)
        print(f"  {step.__name__[len('_par_'):]}: {time.perf_counter() - t0:.1f} s")
    return cg64


# ---------------------------------------------------------------------------
# the multi-process mesh: torch.distributed behind the collectives
# ---------------------------------------------------------------------------

#: the two-process run: viennacl_large by sharded CG (fp64, the JAX demo's
#: policy) and rung-5 Poisson MP_GRID^3 by probed MGCG (fp32) on 2 ranks x
#: 2 shards of the one card over Gloo (NCCL refuses two ranks on one GPU)
MP_PROCS = 2
MP_LOCAL = 2
MP_WORKLOAD = "viennacl_large"
MP_GRID = 255
#: the launcher's limit (its workers are killed past it), seconds
MP_TIMEOUT = 240
#: owned x blocks against the one-process run where they are not bit-equal
MP_X_REL = 1e-6


def _mp_nccl_world1(cg64, dev, card, count):
    """(a): one rank over NCCL in this process, the flagship assembled on
    its 4 shards of the card and solved by fp64 sharded CG at the parallel
    phase's policy: its count and x equal that phase's (no process group)
    bit for bit, kernel #4 as the recurrence implies."""
    import torch.distributed as dist

    from conjugategradient_tpu_torch.parallel import multihost
    from conjugategradient_tpu_torch.scripts.multiprocess_demo import free_port

    tag = f"multi-process: NCCL world 1, sharded CG {FLAGSHIP} fp64 on {PAR_SHARDS} shards"
    t0 = time.perf_counter()
    multihost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, strict=True)
    try:
        _require(dist.get_backend() == "nccl", f"{tag}: backend {dist.get_backend()}")
        mesh = multihost.global_mesh(devices=[dev] * PAR_SHARDS)
        _require(mesh.comm is not None and mesh.owned == range(PAR_SHARDS), f"{tag}: {mesh}")
        A, b, x0, n = make_distributed_system(FLAGSHIP, mesh)
        pol = dataclasses.replace(WORKLOADS[FLAGSHIP].policy, max_iteration=PAR_CAP)
        solve = make_sharded_cg(A, mesh, pol)
        t_init = time.perf_counter() - t0
        _reset_counts()
        t0 = time.perf_counter()
        res = solve(A.data, b, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k4 = _k4_launches()
        its, x_ref = cg64
        x = torch.cat(res.x.parts).cpu()
        _require(res.converged and res.iterations == its and torch.equal(x, x_ref),
                 f"{tag}: {res.iterations} iterations against {its} without a process group, x "
                 f"bit-equal {torch.equal(x, x_ref)}")
        want = _par_want("cg", PAR_SHARDS, res.iterations, 0)
        _require(k4 == want, f"{tag}: {k4} kernel #4 launches, the recurrence implies {want}")
        count(tag, {"spmv_dia": k4}, fp32=False)
        print(f"{tag}: {res.iterations} iterations and x bit-equal to the mesh without a process "
              f"group; kernel #4 {k4} launches = {want} implied; init + assembly {t_init:.3f} s, "
              f"solve {wall * 1e3:.3f} ms, of it {mesh.comm.seconds * 1e3:.3f} ms in "
              f"{mesh.comm.calls} communicator calls [{card}]")
    finally:
        dist.destroy_process_group()


def _mp_plan(rec):
    """The one field of a ``ShardPlan`` that ``_smg_want`` reads, from a
    ``run_mgcg`` record."""
    return types.SimpleNamespace(products_per_cycle=rec["products_per_cycle"])


def _mp_setup_want(setup_products, num, owned) -> int:
    """Kernel #3's launches of a probed setup on a process owning ``owned``
    of ``num`` shards: its shards' part of each sharded level's probes, the
    replicated levels' whole."""
    return sum(p * (owned if s == num else s) for _, s, p in setup_products)


def _mp_two_ranks(dev, card, count):
    """(b): the port's launcher with two ranks on the card over Gloo (CUDA
    parts staged through host buffers): viennacl_large by sharded CG and
    rung-5 MP_GRID^3 by probed MGCG, each worker's own shards held to the
    fp64 oracle (CG) and converged (MGCG); then the same MGCG on a
    one-process 4-shard mesh here: the same count and the owned x blocks
    bit for bit (else within MP_X_REL), each worker's #3 and #4 launches as
    the recurrences imply, the walls and the communicator's seconds."""
    from conjugategradient_tpu_torch.scripts import multiprocess_demo as mp

    num = MP_PROCS * MP_LOCAL
    tag = f"multi-process: {MP_PROCS} ranks x {MP_LOCAL} shards of the card over gloo"
    out = tempfile.mkdtemp(prefix="multiprocess_")
    torch.cuda.empty_cache()
    cmd = [sys.executable, "-m", "conjugategradient_tpu_torch.scripts.multiprocess_demo",
           "--procs", str(MP_PROCS), "--local-devices", str(MP_LOCAL), "--device", "cuda",
           "--backend", "gloo", "--workload", MP_WORKLOAD, "--mgcg", "--grid", str(MP_GRID),
           "--reps", "2", "--out", out, "--timeout", str(MP_TIMEOUT)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=os.path.dirname(os.path.abspath(__file__)),
                          capture_output=True, text=True, timeout=MP_TIMEOUT + 60)
    t_launch = time.perf_counter() - t0
    for line in proc.stdout.splitlines():
        print(f"  {line}")
    _require(proc.returncode == 0 and '"verdict": "OK"' in proc.stdout,
             f"{tag}: the launcher exited {proc.returncode}: {proc.stderr[-3000:]}")
    recs = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(MP_PROCS)]
    shutil.rmtree(out, ignore_errors=True)

    # the one-process reference: the same MGCG on 4 shards of the card here
    mesh = make_mesh(num, devices=[dev] * num)
    ref = mp.run_mgcg(mesh, MP_GRID, reps=2)
    _require(ref["converged"], f"{tag}: the one-process MGCG did not converge")
    k3 = lambda c: c["spmv_stencil"] + c["spmv_stencil_wide"]  # noqa: E731
    want1 = _smg_want("cg", ref["iterations"], 1, _mp_plan(ref), num,
                      ref["tail_products"])
    _require(k3(ref["counts"]) == want1, f"{tag}: the one-process MGCG launched #3 "
             f"{k3(ref['counts'])} times, the recurrence implies {want1}")
    x_ref = ref["x"]
    worst, bits = 0.0, True
    walls = []
    for r, rec in enumerate(recs):
        cg, mg = rec["cg"], rec["mgcg"]
        _require(rec["ok"] and cg["ok"] and mg["converged"] and rec["world"] == MP_PROCS
                 and rec["owned"] == list(range(r * MP_LOCAL, (r + 1) * MP_LOCAL)),
                 f"{tag}: rank {r}: {rec['owned']}, ok {rec['ok']}")
        want4 = _par_want("cg", MP_LOCAL, cg["iterations"], 0)
        _require(cg["counts"]["spmv_dia"] == want4, f"{tag}: rank {r} CG launched #4 "
                 f"{cg['counts']['spmv_dia']} times, the recurrence implies {want4}")
        _require(mg["iterations"] == ref["iterations"] and mg["products_per_cycle"] ==
                 ref["products_per_cycle"] and mg["tail_products"] == ref["tail_products"],
                 f"{tag}: rank {r} MGCG {mg['iterations']} iterations against the one-process "
                 f"{ref['iterations']}")
        want3 = _smg_want("cg", mg["iterations"], 1, _mp_plan(mg), MP_LOCAL,
                          mg["tail_products"])
        _require(k3(mg["counts"]) == want3, f"{tag}: rank {r} MGCG launched #3 "
                 f"{k3(mg['counts'])} times, the recurrence implies {want3}")
        want_setup = _mp_setup_want(mg["setup_products"], num, MP_LOCAL)
        _require(k3(mg["setup_counts"]) == want_setup, f"{tag}: rank {r} probed setup launched "
                 f"#3 {k3(mg['setup_counts'])} times, the code implies {want_setup}")
        for i, part in zip(rec["owned"], mg["x"]):
            bits = bits and torch.equal(part, x_ref[i])
            worst = max(worst, float((part - x_ref[i]).abs().max() / x_ref[i].abs().max()))
        count(f"{tag}: rank {r} sharded CG {MP_WORKLOAD} fp64",
              {"spmv_dia": cg["counts"]["spmv_dia"]}, fp32=False)
        count(f"{tag}: rank {r} rung-5 {MP_GRID}^3 probed setup + MGCG fp32",
              {"spmv_stencil": mg["setup_counts"]["spmv_stencil"] + mg["counts"]["spmv_stencil"],
               "spmv_stencil_wide": (mg["setup_counts"]["spmv_stencil_wide"]
                                     + mg["counts"]["spmv_stencil_wide"])})
        walls.append(mg["solve_s"][-1])
        print(f"{tag}: rank {r} shards {rec['owned']}: CG {cg['iterations']} iterations (own "
              f"shards against the fp64 oracle {cg['worst_rel_err']:.3e}), #4 {want4} launches "
              f"as implied; assembly {cg['assembly_s']:.3f} s, solve {cg['solve_s']:.3f} s, "
              f"communicator {cg['comm_s']:.3f} s. MGCG {mg['iterations']} iterations, #3 "
              f"{k3(mg['counts'])} launches and setup #3 {k3(mg['setup_counts'])} as implied; "
              f"assembly {mg['assembly_s']:.3f} s, probed setup {mg['setup_s']:.3f} s, warm solve "
              f"{mg['solve_s'][-1]:.3f} s of it {mg['comm_s'][-1]:.3f} s in the communicator "
              f"(first solve {mg['solve_s'][0]:.3f} s) [{card}]")
    _require(bits or worst <= MP_X_REL, f"{tag}: owned x blocks differ from the one-process run's "
             f"by {worst:.3e} > {MP_X_REL}")
    gap = max(walls) - ref["solve_s"][-1]
    comm = max(rec["mgcg"]["comm_s"][-1] for rec in recs)
    print(f"{tag}: rung-5 {MP_GRID}^3 MGCG {ref['iterations']} iterations on both meshes, owned x "
          f"blocks {'bit-equal' if bits else f'within {worst:.3e}'} to the one-process 4-shard "
          f"run's; warm wall {max(walls):.3f} s on two processes against "
          f"{ref['solve_s'][-1]:.3f} s on one (probed setup {ref['setup_s']:.3f} s, assembly "
          f"{ref['assembly_s']:.3f} s): "
          f"the gap {gap:.3f} s, communicator {comm:.3f} s ({comm / gap if gap > 0 else 0:.1%} of "
          f"it); the launcher {t_launch:.1f} s [{card}]")


def _multi_process(cg64, dev, card, count):
    """The multi-process mesh: (a) NCCL at world size 1 in this process,
    (b) two Gloo ranks on the one card; each step's seconds."""
    for step, args in ((_mp_nccl_world1, (cg64, dev, card, count)),
                       (_mp_two_ranks, (dev, card, count))):
        t0 = time.perf_counter()
        step(*args)
        print(f"  {step.__name__[len('_mp_'):]}: {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# the sharded multigrid: shard_mgcg, shard_multi, the GSPMD carriers
# ---------------------------------------------------------------------------

SMG_SHARDS = 4
SMG_K = 4
#: the facade's replicated odd grid and the (n, k) facade's grid
SMG_ODD = (1023, 1023)
SMG_BLOCK_GRID = (512, 512)


def _k3_launches() -> int:
    """Kernel #3's launches since the last reset, tuned and wide."""
    return spmv_stencil_cuda.launches + spmv_stencil_wide_cuda.launches


def _smg_tail_products(h, plan) -> int:
    """Kernel #3's launches one replicated-tail cycle makes for one column:
    the single-device ``v_cycle`` once, on the first shard's device, over
    the tail's variable-coefficient levels, counted as ``ShardPlan`` counts
    a sharded level's products (its constant levels run #1 and #2)."""
    sweeps = lambda n: 0 if n <= 0 else {"chebyshev": 1 + n, "rbgs": 2 * n}.get(h.smoother, n)
    return sum(sweeps(h.pre) + sweeps(h.post) + 1 + (2 if l.transfer == "agg" and l.sa_smooth else 0)
               for l in h.levels[plan.n_sharded:] if isinstance(l.A, StencilMatrix))


def _smg_want(variant, its, cols, plan, num, tail=0) -> int:
    """Kernel #3's launches a sharded MGCG implies: one a shard a column
    per sharded-level product.  The outer loop's products: the initial
    residual and one an iteration (cg), two at the start (cg1, pipelined);
    one V-cycle at the start and one an iteration, each
    ``plan.products_per_cycle`` sharded products and ``tail`` launches of
    the replicated tail a column (``_smg_tail_products``)."""
    products = its + (1 if variant == "cg" else 2)
    return num * cols * (products + (its + 1) * plan.products_per_cycle) + cols * (its + 1) * tail


def _smg_plan(tag, solve, outer_halo):
    plan = solve.plan
    print(f"{tag}: n_sharded {plan.n_sharded}; sharded levels (grid, local extent, halo0, "
          f"transfer) {list(plan.levels)}; replicated tail {list(plan.tail)} + dense "
          f"{plan.coarse}; {plan.products_per_cycle} sharded products a V-cycle; halo bytes an "
          f"iteration: {outer_halo} (the outer product's slabs) + {plan.halo_bytes_per_cycle} "
          f"(the V-cycle's level slabs) + {plan.cc_bytes_per_cycle} (the cc transfers' "
          f"1-element pairs)")


def _smg_check(tag, s, x, rel_bound=TRUE_REL):
    _require(tuple(x.shape) == (s.n,) and bool(torch.isfinite(x).all()), f"{tag}: bad x")
    rel = _host_rel_residual(s.A, s.b, x.cpu().numpy())
    _require(rel <= rel_bound, f"{tag}: true fp64 relative residual {rel:.3e} > {rel_bound}")
    return rel


def _smg_solves(tag, s, grid, h, meshes, variants, dev, card, count, pol):
    """``make_shard_mgcg`` over ``h`` by each (shards, variant), counted:
    converged, the count within 2 of ``mgcg_solve``'s on the same
    hierarchy, the true residual within TRUE_REL, kernel #3 launched once a
    shard per sharded-level product.  Returns the solvers, their results
    and the single-device result."""
    t0 = time.perf_counter()
    b_dev = torch.from_numpy(s.b).to(dev, torch.float32)
    single = mgcg_solve(s.A, b_dev, grid, policy=pol, hierarchy=h)[0]
    torch.cuda.synchronize()
    print(f"mgcg_solve {tag}: {single.iterations} iterations in {time.perf_counter() - t0:.3f} s")
    out = {}
    for num, variant in variants:
        t_set = time.perf_counter()
        solve, (b, x0) = make_shard_mgcg(s, grid, meshes[num], pol, hierarchy=h,
                                         dtype=np.float32, variant=variant)
        torch.cuda.synchronize()
        t_set = time.perf_counter() - t_set
        _reset_counts()
        t0 = time.perf_counter()
        res = solve(b, x0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _k3_launches()
        want = _smg_want(variant, res.iterations, 1, solve.plan, num,
                         _smg_tail_products(h, solve.plan))
        path = f"shard_mgcg {tag} {num} shard(s) {variant}"
        _require(res.converged and abs(res.iterations - single.iterations) <= 2,
                 f"{path}: {res.iterations} iterations (converged {res.converged}) against "
                 f"mgcg_solve's {single.iterations}")
        _require(got == want, f"{path}: kernel #3 launched {got} times, the recurrence implies {want}")
        t_chk = time.perf_counter()
        rel = _smg_check(path, s, res.x)
        t_chk = time.perf_counter() - t_chk
        count(path, {"spmv_stencil": spmv_stencil_cuda.launches,
                     "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
        wide = {str(g): v for g, v in sorted(spmv_stencil_wide_cuda.launches_by_grid.items(),
                                             reverse=True)}
        print(f"{path}: {res.iterations} iterations (mgcg_solve {single.iterations}), rel_l2 "
              f"{float(res.residual):.3e}, true fp64 rel residual {rel:.3e}; kernel #3 launches "
              f"{got} = {want} implied (wide #3 by grid {wide}); setup {t_set:.3f} s, first call "
              f"{wall:.3f} s, host residual check {t_chk:.3f} s [{card}]")
        out[(num, variant)] = (solve, b, x0, res)
    if (SMG_SHARDS, "cg") in out:
        solve = out[(SMG_SHARDS, "cg")][0]
        _smg_plan(f"shard_mgcg {tag} {SMG_SHARDS} shards", solve, solve.operators[0].halo_bytes)
    return out, single, b_dev


def _smg_times(tag, s, grid, h, out, single_b, pol, card):
    """Warm medians of WALL_REPS: the 4-shard and 1-shard cg solves and the
    single-device mgcg_solve, each with its device busy share."""
    runs = {f"{SMG_SHARDS} shards": out[(SMG_SHARDS, "cg")],
            "1 shard": out[(1, "cg")]}
    fns = {k: (lambda v=v: v[0](v[1], v[2])) for k, v in runs.items()}
    fns["mgcg_solve"] = lambda: mgcg_solve(s.A, single_b, grid, policy=pol, hierarchy=h)
    res = {}
    for k, fn in fns.items():
        walls = _wall_median_ms(fn)
        busy = _par_profile(f"shard_mgcg {tag} {k}", fn, walls[0], card)
        res[k] = walls[0]
        print(f"time shard_mgcg {tag} {k}: warm wall {_fmt_wall(walls)}, device busy {busy:.1%} "
              f"[{card}]")
    return res


def _smg_slab_kernel(s, h, solve, dev, card, times):
    """Kernel #3 on one shard's extended slab (shard 1 of SMG_SHARDS of the
    256^3 fine level, its legs as the solve holds them): its local rows
    against #3 on the global grid's rows, against the twin, and timed
    beside its bound and cuSPARSE's CSR product of the same rows."""
    op = solve.operators[1]
    A = op.mats.parts[1]
    H, n0 = op.halo, op.local[0]
    lvl = h.levels[0]
    A_glob = StencilMatrix(_const_legs(lvl.A, 0, lvl.grid[0], torch.float32, dev), lvl.A.shifts,
                           lvl.grid)
    gen = torch.Generator(device=dev).manual_seed(SEED + 19)
    x = torch.randn(lvl.grid, generator=gen, device=dev)
    x_ext = x[n0 - H:2 * n0 + H].contiguous()
    y = spmv_stencil_cuda(A, x_ext)
    y_glob = spmv_stencil_cuda(A_glob, x)[n0:2 * n0]
    mid = y[H:H + n0]
    same = torch.equal(mid, y_glob)
    if not same:
        scale = spmv_stencil_ref(StencilMatrix(A.data.abs(), A.shifts, A.grid), x_ext.abs())[H:H + n0]
        _require(bool(((mid - y_glob).abs() <= KERNEL_REL * scale).all()),
                 "shard slab #3: local rows differ from the global rows beyond KERNEL_REL")
    ref = spmv_stencil_ref(A, x_ext)
    err, scale = _max_err(y, ref)
    _require(err <= KERNEL_REL * scale, f"shard slab #3: max err {err:.3e} against the twin")
    k_ms = time_ms(lambda: spmv_stencil_cuda(A, x_ext), 50)
    p_ms = time_ms(lambda: spmv_stencil_ref(A, x_ext), 3)
    csr = _stencil_csr(A)
    lib_ms = _library("spmv_stencil one shard slab", lambda: csr @ x_ext.reshape(-1),
                      y.reshape(-1), card, 50)
    del csr
    n = x_ext.numel()
    nbytes = A.nnz * 4 + 2 * n * 4
    bound = bound_ms(nbytes, 2 * A.nnz)
    times["shard slab"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                               library_ms=lib_ms)
    print(f"time spmv_stencil on one of {SMG_SHARDS} shards' extended slab {tuple(A.grid)} x "
          f"{A.nlegs} legs fp32: local rows {'bit-equal to' if same else 'within KERNEL_REL of'} "
          f"#3 on the global grid's rows, max err against the twin {err:.3e}; kernel {k_ms:.4f} ms "
          f"({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms by {bound[1]}, {bound[0] / k_ms:.1%} "
          f"of it), twin {p_ms:.4f} ms, CSR {lib_ms:.4f} ms [{card}]")
    del A_glob, x, x_ext, y, y_glob, ref
    return err


def _smg_dia_kernel(padded, dev, card, times):
    """Kernel #5 on one shard's extended DIA of the padded flagship at k =
    SMG_K: against its twin, each column against #4, timed beside its
    bound and cuSPARSE's CSR product."""
    n_local = padded.n // SMG_SHARDS
    hb = max(abs(o) for o in padded.A.offsets)
    data = torch.from_numpy(padded.A.data[:, n_local:2 * n_local]).to(dev, torch.float32)
    ext = extend_rows(data, hb)
    L = ext.shape[1]
    A = DiaMatrix(ext, tuple(padded.A.offsets), (L, L))
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)
    X = torch.randn((SMG_K, L), generator=gen, device=dev)
    Y = spmm_dia_cuda(A, X)
    ref = spmm_dia_ref(A, X)
    err, scale = _max_err(Y, ref)
    _require(err <= KERNEL_REL * scale, f"shard DIA #5: max err {err:.3e} against the twin")
    for j in range(SMG_K):
        _require(torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous())),
                 f"shard DIA #5: column {j} differs from kernel #4's product")
    k_ms = time_ms(lambda: spmm_dia_cuda(A, X), 200)
    p_ms = time_ms(lambda: spmm_dia_ref(A, X), 5)
    csr = dia_csr(A)
    lib_ms = _library(f"spmm_dia one shard k={SMG_K}", lambda: (csr @ X.T).T, Y, card, 200)
    nbytes = spmm_bytes(A, SMG_K)
    bound = bound_ms(nbytes, 2 * dia_nnz(A) * SMG_K)
    times["shard dia"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                              library_ms=lib_ms)
    print(f"time spmm_dia on one of {SMG_SHARDS} shards' extended DIA ({L} rows, {A.ndiags} "
          f"diagonals) k={SMG_K} fp32: max err against the twin {err:.3e}, every column #4's bit "
          f"for bit; kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms by "
          f"{bound[1]}, {bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms, CSR {lib_ms:.4f} ms "
          f"[{card}]")
    return err


def _smg_block_flagship(fsys, meshes, dev, card, count):
    """``sharded_cg_multi_solve`` on the flagship padded to SMG_SHARDS, k =
    SMG_K, fp32 cg and bicgstab: counts within 2 of the one-device block
    solvers', kernel #5 once a shard per block product.  Returns the padded
    system."""
    padded, _ = pad_system(fsys, SMG_SHARDS)
    rng = np.random.default_rng(SEED + 21)
    B = np.concatenate([padded.b[:, None], rng.standard_normal((padded.n, SMG_K - 1))], axis=1)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    A_dev = padded.A.device_put(torch.float32, dev)
    B_dev = torch.from_numpy(B).to(dev, torch.float32)
    for method, one in (("cg", cg_solve_multi), ("bicgstab", bicgstab_solve_multi)):
        ref = one(A_dev, B_dev, policy=pol)
        spmm_dia_cuda.launches = 0
        r = sharded_cg_multi_solve(padded.A, B, policy=pol, mesh=meshes[SMG_SHARDS],
                                   dtype=np.float32, method=method)
        torch.cuda.synchronize()
        its, its1 = r.iterations.cpu().numpy(), ref.iterations.cpu().numpy()
        top = int(its.max())
        want = SMG_SHARDS * (1 + (1 if method == "cg" else 2) * top)
        path = f"sharded_cg_multi_solve flagship {SMG_SHARDS} shards {method} k={SMG_K}"
        _require(bool(r.converged.all()) and np.abs(its - its1).max() <= 2,
                 f"{path}: iterations {its.tolist()} against {its1.tolist()}")
        _require(spmm_dia_cuda.launches == want,
                 f"{path}: kernel #5 launched {spmm_dia_cuda.launches} times, {want} implied")
        count(path, {"spmm_dia": spmm_dia_cuda.launches})
        rels = [float(np.linalg.norm(B[:, j] - oracle.spmv(padded.A, r.x[:, j].cpu().double()
                                                          .numpy())) / np.linalg.norm(B[:, j]))
                for j in range(SMG_K)]
        _require(max(rels) <= TRUE_REL, f"{path}: true residuals {rels}")
        print(f"{path}: iterations by column {its.tolist()} (one device {its1.tolist()}), true fp64 "
              f"rel residuals {[f'{v:.2e}' for v in rels]}; kernel #5 launches "
              f"{spmm_dia_cuda.launches} = {want} implied [{card}]")
    return padded, B


def _smg_facade(s3, h3, s2, h2, padded, Bf, meshes, dev, card, count):
    """``api.solve(..., mesh=)``: mgcg on the odd 1023^2 (replicated: the
    single-device solve bit for bit), on 256^3 (sharded), refined on 1024^2
    to ||r||_2 < 1e-8 (the fp64 residual on #4 per shard), the (n, k) mgcg
    and cg routes."""
    mesh = meshes[SMG_SHARDS]
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    opts = dict(tol=TOL, norm="rel_l2", dtype=np.float32, device=dev)
    so = generators.poisson_system(SMG_ODD)
    _reset_counts()
    r = api.solve(so.A, so.b, method="mgcg", grid=SMG_ODD, mesh=mesh, **opts)
    counted = {"spmv_const_stencil": spmv_const_stencil_cuda.launches,
               "cheb_smooth_const": cheb_smooth_const_cuda.launches}
    ref = mgcg_solve(so.A, so.b, SMG_ODD, policy=pol, dtype=np.float32, device=dev)[0]
    path = f"api.solve(method='mgcg', mesh={SMG_SHARDS} shards) {SMG_ODD}"
    _require(r.iterations == ref.iterations and torch.equal(r.x, ref.x),
             f"{path}: {r.iterations} iterations, x not mgcg_solve's")
    count(path, counted)
    print(f"{path}: replicated (1023 does not divide the mesh), {r.iterations} iterations, x "
          f"bit-identical to mgcg_solve's; launches {counted}")
    _reset_counts()
    r = api.solve(s3.A, s3.b, method="mgcg", grid=KIND_GRID_3D, mesh=mesh, hierarchy=h3, **opts)
    counted = {"spmv_stencil": spmv_stencil_cuda.launches,
               "spmv_stencil_wide": spmv_stencil_wide_cuda.launches}
    single = mgcg_solve(s3.A, s3.b, KIND_GRID_3D, policy=pol, hierarchy=h3)[0]
    _require(r.converged and abs(r.iterations - single.iterations) <= 2,
             f"facade mgcg {KIND_GRID_3D} mesh: {r.iterations} against {single.iterations}")
    rel = _smg_check("facade mgcg 256^3", s3, r.x)
    path = f"api.solve(method='mgcg', mesh={SMG_SHARDS} shards) {KIND_GRID_3D}"
    count(path, counted)
    print(f"{path}: sharded, {r.iterations} iterations (mgcg_solve {single.iterations}), true fp64 "
          f"rel residual {rel:.3e}, kernel #3 launches {sum(counted.values())}")
    cuda_dia.reset_launch_counts()
    _reset_counts()
    t0 = time.perf_counter()
    rr = api.solve(s2.A, s2.b, method="refined", grid=KIND_GRID_2D, mesh=mesh, tol=1e-8,
                   hierarchy=h2)
    wall = time.perf_counter() - t0
    k4 = spmv_dia_cuda.launches_by_dtype.get("fp64", 0)
    counted = {"spmv_dia": spmv_dia_cuda.launches, "spmv_stencil": spmv_stencil_cuda.launches,
               "spmv_stencil_wide": spmv_stencil_wide_cuda.launches}
    true = float(np.linalg.norm(s2.b - oracle.spmv(s2.A, rr.x)))
    one = refined_solve(s2.A, s2.b, grid=KIND_GRID_2D, tol=1e-8, hierarchy=h2,
                        device_residual=True, device=dev)
    _require(rr.converged and true < 1e-8 and abs(rr.outer_iterations - one.outer_iterations) <= 1,
             f"facade refined mesh: {rr.outer_iterations} passes (one device "
             f"{one.outer_iterations}), true ||r||_2 {true:.3e}")
    _require(k4 == SMG_SHARDS * (rr.outer_iterations + 1),
             f"facade refined mesh: fp64 kernel #4 launched {k4} times, "
             f"{SMG_SHARDS * (rr.outer_iterations + 1)} implied")
    path = f"api.solve(method='refined', mesh={SMG_SHARDS} shards) {KIND_GRID_2D}"
    count(path, counted)
    print(f"{path}: {rr.outer_iterations} outer passes (refined_solve device_residual "
          f"{one.outer_iterations}), {rr.inner_iterations} inner iterations, true ||r||_2 "
          f"{true:.3e}; fp64 kernel #4 launches {k4} = {SMG_SHARDS} x (passes + 1); wall "
          f"{wall:.3f} s [{card}]")
    sb = generators.poisson_system(SMG_BLOCK_GRID)
    B = np.random.default_rng(SEED + 22).standard_normal((sb.n, SMG_K))
    _reset_counts()
    r = api.solve(sb.A, B, method="mgcg", grid=SMG_BLOCK_GRID, mesh=mesh, **opts)
    path = f"api.solve(B n x {SMG_K}, method='mgcg', mesh={SMG_SHARDS} shards) {SMG_BLOCK_GRID}"
    count(path, {"spmv_stencil": spmv_stencil_cuda.launches,
                 "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
    one = api.solve(sb.A, B, method="mgcg", grid=SMG_BLOCK_GRID, **opts)
    its, its1 = r.iterations.cpu().numpy(), one.iterations.cpu().numpy()
    _require(bool(r.converged.all()) and np.abs(its - its1).max() <= 2,
             f"{path}: {its.tolist()} against {its1.tolist()}")
    print(f"{path}: iterations by column {its.tolist()} (one device {its1.tolist()})")
    spmm_dia_cuda.launches = 0
    r = api.solve(padded.A, Bf, method="cg", mesh=mesh, **opts)
    path = f"api.solve(B n x {SMG_K}, method='cg', mesh={SMG_SHARDS} shards) flagship"
    _require(bool(r.converged.all()) and spmm_dia_cuda.launches > 0, f"{path}: failed")
    count(path, {"spmm_dia": spmm_dia_cuda.launches})
    print(f"{path}: iterations by column {r.iterations.cpu().numpy().tolist()}, kernel #5 "
          f"launches {spmm_dia_cuda.launches}")


def _smg_columns(s):
    """SMG_K right-hand sides in the Poisson generator's family: column j
    is ``sin(f_j i + j) + 0.25 cos(1.3 i)`` over the flat index i, column 0
    the system's own b (f_0 = 0.37).  Like b, their solutions are not
    dominated by the smoothest modes, so an fp32 solve can reach TRUE_REL
    (seeded normal columns sat at 1.3-2.2e-5 on 1024^2 on one device too);
    their counts differ, so columns freeze at different iterations."""
    i = np.arange(s.n, dtype=np.float64)
    return np.stack([np.sin(f * i + j) + 0.25 * np.cos(1.3 * i)
                     for j, f in enumerate((0.37, 0.53, 0.71, 0.89)[:SMG_K])], axis=1)


def _sharded_multigrid(poisson3, galerkin2, fsys, dev, card, count, errs, times):
    """The sharded multigrid on one card: shard_mgcg_solve on
    Poisson 256^3 (cg, cg1, pipelined on SMG_SHARDS shards, cg on 1) and
    1024^2 (Chebyshev and rbgs), the multi-RHS MGCG, the flat block solver
    on the flagship, the facade's mesh routes, kernels #3 and #5 at the
    shards' shapes, the warm times; each step's seconds."""
    s3, h3 = poisson3
    s2, h2 = galerkin2
    meshes = {n: make_mesh(n, devices=[dev] * n) for n in (SMG_SHARDS, 1)}
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    t0 = time.perf_counter()
    out3, single3, b3 = _smg_solves("Galerkin Poisson 256^3", s3, KIND_GRID_3D, h3, meshes,
                                    ((SMG_SHARDS, "cg"), (SMG_SHARDS, "cg1"),
                                     (SMG_SHARDS, "pipelined"), (1, "cg")), dev, card, count, pol)
    x4, x1 = out3[(SMG_SHARDS, "cg")][3].x, out3[(1, "cg")][3].x
    dx = float((x4 - x1).abs().max() / x1.abs().max())
    bound = PAR_X_AGREE[torch.float32]
    _require(dx <= bound, f"shard_mgcg 256^3: 4-shard x against 1-shard x {dx:.3e} > {bound}")
    print(f"shard_mgcg Galerkin Poisson 256^3: {SMG_SHARDS}-shard x within {dx:.3e} of the 1-shard "
          f"x (bound {bound})")
    print(f"  256^3 solves: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    out2, _, _ = _smg_solves("Galerkin Poisson 1024^2", s2, KIND_GRID_2D, h2, meshes,
                             ((SMG_SHARDS, "cg"),), dev, card, count, pol)
    hr = _kind_hierarchy(f"Galerkin Poisson {KIND_GRID_2D} rbgs", s2, KIND_GRID_2D, dev,
                         smoother="rbgs")
    _smg_solves("Galerkin Poisson 1024^2 rbgs", s2, KIND_GRID_2D, hr, meshes,
                ((SMG_SHARDS, "cg"),), dev, card, count, pol)
    del hr
    B2 = _smg_columns(s2)
    _reset_counts()
    r = shard_multi_mgcg_solve(s2, B2, KIND_GRID_2D, mesh=meshes[SMG_SHARDS], policy=pol,
                               hierarchy=h2, dtype=np.float32)
    torch.cuda.synchronize()
    got = _k3_launches()
    counted = {"spmv_stencil": spmv_stencil_cuda.launches,
               "spmv_stencil_wide": spmv_stencil_wide_cuda.launches}
    ref = cg_solve_multi(h2.levels[0].A, torch.from_numpy(B2).to(dev, torch.float32), policy=pol,
                         M=as_multi_preconditioner(h2))
    its, its1 = r.iterations.cpu().numpy(), ref.iterations.cpu().numpy()
    path = f"shard_multi_mgcg Galerkin Poisson 1024^2 {SMG_SHARDS} shards k={SMG_K}"
    _require(bool(r.converged.all()) and np.abs(its - its1).max() <= 2,
             f"{path}: {its.tolist()} against cg_solve_multi's {its1.tolist()}")
    rels, rels1 = ([_host_rel_residual(s2.A, B2[:, j], X[:, j].cpu().double().numpy())
                    for j in range(SMG_K)] for X in (r.x, ref.x))
    _require(max(rels) <= TRUE_REL and max(rels1) <= TRUE_REL,
             f"{path}: true residuals {rels}, the one-device block solve's {rels1}")
    plan2 = out2[(SMG_SHARDS, "cg")][0].plan
    want = _smg_want("cg", int(its.max()), SMG_K, plan2, SMG_SHARDS, _smg_tail_products(h2, plan2))
    _require(got == want, f"{path}: kernel #3 launched {got} times, {want} implied")
    count(path, counted)
    print(f"{path}: iterations by column {its.tolist()} (cg_solve_multi {its1.tolist()}), true "
          f"fp64 rel residuals {[f'{v:.2e}' for v in rels]} (one device "
          f"{[f'{v:.2e}' for v in rels1]}); kernel #3 launches {got} = {want} implied [{card}]")
    print(f"  1024^2 solves: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    padded, Bf = _smg_block_flagship(fsys, meshes, dev, card, count)
    print(f"  flagship blocks: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _smg_facade(s3, h3, s2, h2, padded, Bf, meshes, dev, card, count)
    print(f"  facade: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["spmv_stencil"] = max(errs["spmv_stencil"],
                               _smg_slab_kernel(s3, h3, out3[(SMG_SHARDS, "cg")][0], dev, card,
                                                times))
    errs["spmm_dia"] = max(errs["spmm_dia"], _smg_dia_kernel(padded, dev, card, times))
    solve4, _, _, res4 = out3[(SMG_SHARDS, "cg")]
    tail = _smg_tail_products(h3, solve4.plan)
    want = _smg_want("cg", res4.iterations, 1, solve4.plan, SMG_SHARDS, tail)
    times["shard slab"]["launches_per_solve"] = want
    print(f"kernel #3 launches per 256^3 {SMG_SHARDS}-shard cg solve: {want} = {SMG_SHARDS} x "
          f"((iterations + 1) x (1 + {solve4.plan.products_per_cycle})) on the shards + (iterations "
          f"+ 1) x {tail} in the tail, iterations {res4.iterations}")
    walls = _smg_times("Galerkin Poisson 256^3", s3, KIND_GRID_3D, h3, out3, b3, pol, card)
    print(f"  kernels and times: {time.perf_counter() - t0:.1f} s")
    print(f"sharded multigrid: {SMG_SHARDS} shards on one card measure what sharding costs (halo "
          f"copies, psums on one device, the unfused smoothing, {SMG_SHARDS}x the launches of "
          f"smaller products), not multi-GPU speed: warm 256^3 walls {walls}")


# ---------------------------------------------------------------------------
# the sharded nonsymmetric family and the distributed AMG
# ---------------------------------------------------------------------------

SNS_SHARDS = 4
#: convection-diffusion at NONSYM_EPS on the even grid: 4 | n, and the
#: rediscretized hierarchy's hybrid levels shard (an odd grid replicates)
SNS_GRID = (1024, 1024)
#: every policy of the phase stops here (IDR's count is matvecs)
SNS_CAP = PAR_CAP
#: Helmholtz at HELM_SHIFT lambda_1, fp64 (fp32 MINRES stalls above TOL)
SNS_HELM = (256, 256)
SNS_CHECK = 16
#: warm calls timed for a median wall (after one discarded)
SNS_REPS = 3
#: iterations of the capped run of the same solve whose trace gives the
#: busy share (a 4-shard mg_bicgstab solve is ~36,600 device ops, 14 s to
#: trace)
SNS_WINDOW = 3
#: a route whose count rounding decides (plain BiCGStab and IDR on the
#: convection) is held to its witness, the one-device solves from b and
#: from b changed by one ulp in one entry, then in another: its SNS_SHARDS-
#: and 1-shard counts within SNS_WITNESS_MARGIN of the range of the
#: witness's counts (readings on the card: BiCGStab 799 and 755 against
#: 755, 786 and 755; IDR 355 and 350 against 350, 355 and 320), and the
#: SNS_SHARDS-shard x within SNS_WITNESS_X times the witness's own x spread
#: (the largest max |x_w - x| / max |x| of a changed b's solve against b's)
#: of the 1-shard x.  Each converged solve carries an error of the size the
#: witness pairs sample; two such errors differ by up to their sum, and a
#: solve stops anywhere within a factor of ~2 below the tolerance
SNS_WITNESS_MARGIN = 0.10
SNS_WITNESS_X = 4.0
#: min_local of the AMG route whose replicated tail keeps stencil levels: on
#: SNS_SHARDS shards of the MTX_GRID natural hierarchy level 0 (512,096 rows
#: a shard) shards, level 1 (79,507 rows, 19,877 a shard) tops the tail as
#: CSR and level 2 (15^3) runs there on kernel #3
SNS_AMG_MIN_LOCAL = 32768


def _sns_counted(fn):
    """``fn()`` from a reset: (result, {kernel: launches}, wall s)."""
    _reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = {"spmv_dia": spmv_dia_cuda.launches, "spmv_stencil": spmv_stencil_cuda.launches,
           "spmv_stencil_wide": spmv_stencil_wide_cuda.launches,
           "spmv_const_stencil": spmv_const_stencil_cuda.launches}
    return res, got, wall


def _k3(got) -> int:
    """Kernel #3's launches in a ``_sns_counted`` record, tuned and wide."""
    return got["spmv_stencil"] + got["spmv_stencil_wide"]


def _sns_route(tag, runs, want, true_of, dtype, count, spread=PAR_COUNT_SPREAD, witness=None):
    """One route on SNS_SHARDS shards, on 1 and on one device (``runs``: key
    -> call; SNS_SHARDS, 1, "one"): each converged with the true fp64
    relative residual (``true_of(x)``) within TRUE_REL, the counts within
    ``spread`` of each other, the 4-shard x within PAR_X_AGREE[dtype] of the
    1-shard x, and every run's launches those ``want(result, key)``
    implies.  ``witness`` (a call returning the one-device ``(count, x)``
    from b changed by one ulp in one entry, then in another) marks a route
    whose count rounding decides: its counts and x are held to the
    witness's instead (SNS_WITNESS_MARGIN, SNS_WITNESS_X).  Returns the
    results."""
    out = {}
    for key, fn in runs.items():
        res, got, wall = _sns_counted(fn)
        path = f"{tag} {key} shard{'s' if key != 1 else ''}" if key != "one" else f"{tag} one device"
        rel = true_of(res.x.reshape(-1).cpu().double().numpy())
        _require(bool(res.converged) and rel <= TRUE_REL,
                 f"{path}: converged {res.converged} in {res.iterations}, true rel {rel:.3e}")
        implied = want(res, key)
        seen = {k: (_k3(got) if k == "#3" else got[k]) for k in implied}
        _require(seen == implied, f"{path}: launches {seen}, the recurrence implies {implied}")
        if key == SNS_SHARDS:
            count(f"sharded nonsymmetric: {path}", got, fp32=dtype == torch.float32)
        out[key] = res
        print(f"{path}: {res.iterations} iterations, true fp64 rel residual {rel:.3e}, launches "
              f"{ {k: v for k, v in got.items() if v} } (implied {implied}), wall {wall:.3f} s")
    its = {k: r.iterations for k, r in out.items()}
    x4, x1 = (out[k].x.reshape(-1) for k in (SNS_SHARDS, 1))
    dx = float((x4 - x1).abs().max() / x1.abs().max())
    if witness is not None:
        w = witness()
        seen = [its["one"]] + [c for c, _ in w]
        lo = int(np.floor((1 - SNS_WITNESS_MARGIN) * min(seen)))
        hi = int(np.ceil((1 + SNS_WITNESS_MARGIN) * max(seen)))
        x_one = out["one"].x.reshape(-1).double().cpu().numpy()
        spread = max(float(np.abs(xw - x_one).max() / np.abs(x_one).max()) for _, xw in w)
        limit = max(PAR_X_AGREE[dtype], SNS_WITNESS_X * spread)
        _require(all(lo <= its[k] <= hi for k in (SNS_SHARDS, 1)),
                 f"{tag}: counts {its} outside [{lo}, {hi}], the witness's {seen} widened by "
                 f"{SNS_WITNESS_MARGIN:.0%}")
        _require(dx <= limit, f"{tag}: 4-shard x against 1-shard x {dx:.3e} > {limit:.3e} "
                 f"({SNS_WITNESS_X} x the witness's x spread {spread:.3e})")
        print(f"{tag}: counts {its} within [{lo}, {hi}] (the one-device counts from b and from b "
              f"changed by one ulp {seen}, widened by {SNS_WITNESS_MARGIN:.0%}); "
              f"{SNS_SHARDS}-shard x within {dx:.3e} of the 1-shard x (bound {limit:.3e}: "
              f"{SNS_WITNESS_X} x the witness's x spread {spread:.3e}; rounding decides this "
              f"route's count)")
        return out
    _require(max(its.values()) - min(its.values()) <= spread,
             f"{tag}: counts {its} spread past {spread}")
    _require(dx <= PAR_X_AGREE[dtype], f"{tag}: 4-shard x against 1-shard x {dx:.3e}")
    print(f"{tag}: counts {its} (spread {spread}), {SNS_SHARDS}-shard x within {dx:.3e} of the "
          f"1-shard x (bound {PAR_X_AGREE[dtype]})")
    return out


def _sns_shard_kernel(tag, A: DiaMatrix, card):
    """Kernel #4 on one shard's extended DIA ``A`` (as a route launched it)
    against its twin, timed beside its bound, the twin and cuSPARSE's
    product of the same matrix."""
    L = A.n
    rng = np.random.default_rng(SEED + 20)
    p = torch.from_numpy(rng.standard_normal(L)).to(A.data.device, A.data.dtype)
    y = spmv_dia_cuda(A, p)
    err, scale = _max_err(y, spmv_dia_ref(A, p))
    rel = KERNEL_REL64 if A.data.dtype == torch.float64 else KERNEL_REL
    _require(err <= rel * scale, f"{tag}: kernel #4 max err {err:.3e} against the twin")
    k_ms = time_ms(lambda: spmv_dia_cuda(A, p), 200)
    t_ms = time_ms(lambda: spmv_dia_ref(A, p), 5)
    csr = dia_csr(A)
    lib_ms = _library(f"spmv_dia {tag}", lambda: csr @ p, y, card, 200)
    nnz = dia_nnz(A)
    nbytes = nnz * A.data.element_size() + 2 * L * p.element_size()
    bound = bound_ms(nbytes, 2 * nnz)
    print(f"time spmv_dia on {tag} ({L} rows, {A.ndiags} diagonals) {TAGS[A.data.dtype]}: max err "
          f"{err:.3e}; kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms by "
          f"{bound[1]}, {bound[0] / k_ms:.1%} of it), twin {t_ms:.4f} ms, CSR {lib_ms:.4f} ms "
          f"[{card}]")


def _amg_cycle_launches(h) -> dict:
    """Kernel launches one V-cycle of ``h`` (``amg.amg_vcycle``) implies:
    each level visited once, its products on its operator's kernel (#1 a
    constant stencil, #3 a variable one, #4 a DIA; a CSR level's run on
    cuSPARSE): the pre- and post-smoothing (Jacobi: one a sweep;
    Chebyshev: one more), the residual, and the smoothed restriction and
    prolongation's one each where the level composes them; a DIA product
    past 256 diagonals is its plan's chained launches."""
    out = {"spmv_dia": 0, "#3": 0, "spmv_const_stencil": 0}
    sweeps = lambda k: 0 if k <= 0 else (k + 1 if h.smoother == "chebyshev" else k)
    for lvl in h.levels:
        A = lvl.A
        key = ("spmv_const_stencil" if isinstance(A, ConstStencilMatrix) else
               "#3" if isinstance(A, StencilMatrix) else "spmv_dia" if isinstance(A, DiaMatrix)
               else None)
        if key is None:
            continue
        composed = lvl.blk_nd is not None or bool(lvl.blk) or lvl.agg is not None
        per = sweeps(h.pre) + sweeps(h.post) + 1 + (2 if lvl.sa_c and composed else 0)
        if key == "spmv_dia":
            per *= len(cuda_dia.dia_plan(A.n, A.ndiags).groups)
        out[key] += per
    return out


def _sns_walls(tag, runs, windows, card):
    """Warm medians of SNS_REPS of each run, and the device busy share and
    device ops of its window (``windows[key]``: the same solve capped at
    SNS_WINDOW iterations; ``_par_profile`` against the window's own
    warm wall)."""
    walls = {}
    for key, fn in runs.items():
        w = _wall_median_ms(fn, reps=SNS_REPS)
        win = windows[key]
        win()
        busy = _par_profile(f"{tag} {key} ({SNS_WINDOW}-iteration window)", win, _wall_ms(win),
                            card)
        walls[key] = w[0]
        print(f"time {tag} {key}: warm wall {_fmt_wall(w, SNS_REPS)}; its {SNS_WINDOW}-iteration "
              f"window's device busy {busy:.1%} [{card}]")
    return walls


def _sns_convection(dev, card, count):
    """Convection-diffusion SNS_GRID at NONSYM_EPS in fp32: bicgstab,
    jacobi_gmres, idr, and mg_bicgstab / mg_gmres over the rediscretized
    hierarchy (Jacobi smoothing), sharded through api.solve(mesh=)."""
    from conjugategradient_tpu_torch.parallel.gspmd import make_gspmd_mg_nonsym
    from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
    from conjugategradient_tpu_torch.solvers.gmres import gmres_solve

    g = SNS_GRID
    t0 = time.perf_counter()
    s = generators.convection_diffusion_system(g, eps=NONSYM_EPS)
    co = generators.convection_diffusion_coarse_operator(NONSYM_EPS)
    meshes = {k: make_mesh(k, devices=[dev] * k) for k in (SNS_SHARDS, 1)}
    true_of = lambda x: _host_rel_residual(s.A, s.b, x)
    opts = dict(tol=TOL, norm="rel_l2", max_iteration=SNS_CAP, dtype=np.float32)
    print(f"convection-diffusion {g} eps {NONSYM_EPS}: n {s.n}, generated in "
          f"{time.perf_counter() - t0:.3f} s")

    def facade(method, **kw):
        kw = {**opts, **kw}
        runs = {k: (lambda m=m: api.solve(s.A, s.b, method=method, mesh=m, **kw))
                for k, m in meshes.items()}
        runs["one"] = lambda: api.solve(s.A, s.b, method=method, device=dev, **kw)
        return runs

    def ulp_witness(method, **kw):
        """The one-device ``(count, x)`` from b with one entry moved by one
        ulp (entry 7 up, entry n/2 down): the spread rounding alone makes."""
        kw = {**opts, **kw}

        def run():
            out = []
            for i, sign in ((7, 1.0), (s.n // 2, -1.0)):
                b = s.b.astype(kw["dtype"])
                b[i] = np.nextafter(b[i], sign * np.inf)
                r = api.solve(s.A, b, method=method, device=dev, **kw)
                _require(bool(r.converged), f"{method} witness: {r.iterations} iterations")
                out.append((r.iterations, r.x.reshape(-1).double().cpu().numpy()))
            return out
        return run

    k4 = lambda per: (lambda r, k: {"spmv_dia": (1 if k == "one" else k) * per(r)})
    t0 = time.perf_counter()
    # BiCGStab and IDR amplify rounding on this transport-dominated operator
    # (on the CPU at 64^2 in fp32: one device 732, 808 and 924 iterations
    # from b and two one-ulp changes of it; 813 and 951 on 1 and 4 shards):
    # their counts and x are held to the witness's (SNS_WITNESS_MARGIN).
    # Plain BiCGStab runs in fp64: in fp32 it does not converge here, the
    # port's (NaN after 947 iterations on one device on the CPU, after 829
    # on 4 shards of the card), the JAX package's (NaN after 1429) and a
    # textbook numpy loop's (residual up to 9.8e13, NaN after 1059) alike
    # (tests/bicgstab_fp32_witness.py, on the CPU); fp64 converges in 748 /
    # 773 / 764 (one device, 1 and 4 shards, the CPU)
    tag = f"convection {g} bicgstab (fp64)"
    _sns_route(tag, facade("bicgstab", dtype=np.float64), k4(lambda r: 1 + 2 * r.iterations),
               true_of, torch.float64, count, witness=ulp_witness("bicgstab", dtype=np.float64))
    tag = f"convection {g} jacobi_gmres restart {NONSYM_RESTART}"
    _sns_route(tag, facade("jacobi_gmres", restart=NONSYM_RESTART),
               k4(lambda r: 1 + r.iterations + 2 * r.cycles), true_of, torch.float32, count)
    tag = f"convection {g} idr s={IDR_S}"
    _sns_route(tag, facade("idr", s=IDR_S),
               k4(lambda r: 1 + r.iterations + r.replacements), true_of, torch.float32, count,
               witness=ulp_witness("idr", s=IDR_S))
    print(f"  plain routes: {time.perf_counter() - t0:.1f} s")
    # kernel #4 at the shape those routes launched it: one shard's rows with
    # zero halo rows (parallel.halo.HaloDia), fp32
    data4 = shard_rows(meshes[SNS_SHARDS], s.A.data, torch.float32)
    halo_op = HaloDia(data4, tuple(s.A.offsets), s.A.bandwidth, False)
    _sns_shard_kernel(f"one of {SNS_SHARDS} shards of convection {g}", halo_op.mats.parts[1], card)
    del data4, halo_op

    t0 = time.perf_counter()
    h = build_hierarchy(s.A, g, smoother="jacobi", coarse_operator=co, dtype=np.float32, device=dev)
    torch.cuda.synchronize()
    print(f"convection {g} hierarchy (Jacobi, rediscretized): levels {[l.grid for l in h.levels]} "
          f"+ dense {h.coarse_inv.shape[0]}, {time.perf_counter() - t0:.3f} s")
    A32 = s.A.device_put(torch.float32, dev)
    b32 = torch.from_numpy(s.b.astype(np.float32)).to(dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=SNS_CAP)
    M1 = as_preconditioner(h)
    walls = {}
    for method, one in (("bicgstab", lambda: bicgstab_solve(A32, b32, policy=pol, M=M1)),
                        ("gmres", lambda: gmres_solve(A32, b32, policy=pol, M=M1,
                                                      restart=NONSYM_RESTART))):
        tag = f"convection {g} mg_{method}"
        plans = {}
        runs = {}
        t1 = time.perf_counter()
        for k, m in meshes.items():
            solve, (bk, xk) = make_gspmd_mg_nonsym(s.A, s.b, g, m, pol, method=method, hierarchy=h,
                                                   dtype=np.float32, restart=NONSYM_RESTART)
            _require(solve.n_sharded >= 1, f"{tag} {k}: the V-cycle did not shard")
            plans[k] = solve.plan
            runs[k] = lambda solve=solve, bk=bk, xk=xk: solve(bk, xk)
        runs["one"] = one
        print(f"{tag}: make_gspmd_mg_nonsym on {SNS_SHARDS} shards and 1 in "
              f"{time.perf_counter() - t1:.3f} s")
        tail = _smg_tail_products(h, plans[SNS_SHARDS])

        def want(r, k, method=method):
            cyc = getattr(r, "cycles", 0)
            products = 1 + (2 * r.iterations if method == "bicgstab" else r.iterations + 2 * cyc)
            vcycles = 2 * r.iterations if method == "bicgstab" else r.iterations + cyc
            if k == "one":  # the outer product on #4, every level's on #3
                whole = _smg_tail_products(h, dataclasses.replace(plans[1], n_sharded=0))
                return {"spmv_dia": products, "#3": vcycles * whole}
            plan = plans[k]
            return {"spmv_dia": 0, "#3": k * (products + vcycles * plan.products_per_cycle)
                    + vcycles * _smg_tail_products(h, plan)}

        out = _sns_route(tag, runs, want, true_of, torch.float32, count)
        print(f"{tag}: {SNS_SHARDS}-shard split: n_sharded {plans[SNS_SHARDS].n_sharded}, sharded "
              f"levels {list(plans[SNS_SHARDS].levels)}, tail {list(plans[SNS_SHARDS].tail)}, "
              f"{plans[SNS_SHARDS].products_per_cycle} sharded products a V-cycle, {tail} tail "
              f"#3 launches a V-cycle; {out[SNS_SHARDS].iterations} iterations")
        if method == "bicgstab":
            polw = dataclasses.replace(pol, max_iteration=SNS_WINDOW)
            windows = {"one": lambda: bicgstab_solve(A32, b32, policy=polw, M=M1)}
            for k, m in meshes.items():
                solve, (bk, xk) = make_gspmd_mg_nonsym(s.A, s.b, g, m, polw, hierarchy=h,
                                                       dtype=np.float32)
                windows[k] = lambda solve=solve, bk=bk, xk=xk: solve(bk, xk)
            t1 = time.perf_counter()
            walls = _sns_walls(tag, {k: runs[k] for k in windows}, windows, card)
            print(f"{tag}: warm walls and traces in {time.perf_counter() - t1:.1f} s")
    print(f"  multigrid routes: {time.perf_counter() - t0:.1f} s")
    return walls


def _sns_helmholtz(dev, card, count):
    """MINRES on Helmholtz SNS_HELM at HELM_SHIFT lambda_1 in fp64."""
    g = SNS_HELM
    s = generators.helmholtz_system(g, HELM_SHIFT * _lam1(g))
    opts = dict(method="minres", tol=TOL, norm="rel_l2", max_iteration=SNS_CAP)
    runs = {k: (lambda k=k: api.solve(s.A, s.b, mesh=make_mesh(k, devices=[dev] * k), **opts))
            for k in (SNS_SHARDS, 1)}
    runs["one"] = lambda: api.solve(s.A, s.b, device=dev, **opts)
    _sns_route(f"Helmholtz {g} shift {HELM_SHIFT} lambda_1 minres (fp64)", runs,
               lambda r, k: {"spmv_dia": (1 if k == "one" else k) * (r.iterations + 2)},
               lambda x: _host_rel_residual(s.A, s.b, x), torch.float64, count)


def _sns_flagship(fsys, dev, card, count):
    """LSMR and the extended-region Chebyshev block loop (check_every
    SNS_CHECK) on the flagship padded to SNS_SHARDS | n, fp32."""
    from conjugategradient_tpu_torch.core.formats import transpose
    from conjugategradient_tpu_torch.parallel.shard_nonsym import (
        make_sharded_nonsym,
        sharded_lsmr_solve,
    )
    padded, _ = pad_system(fsys, SNS_SHARDS)
    A = padded.A
    meshes = {k: make_mesh(k, devices=[dev] * k) for k in (SNS_SHARDS, 1)}
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=SNS_CAP)
    At = transpose(A)
    true_of = lambda x: max(_host_rel_residual(A, padded.b, x),
                            _normal_rel(A, At, padded.b, x))
    runs = {k: (lambda m=m: sharded_lsmr_solve(A, padded.b, policy=pol, mesh=m, dtype=np.float32))
            for k, m in meshes.items()}
    runs["one"] = lambda: api.solve(A, padded.b, method="lsmr", tol=TOL, norm="rel_l2",
                                    max_iteration=SNS_CAP, dtype=np.float32, device=dev)
    _sns_route(f"flagship padded to {A.n} lsmr", runs,
               lambda r, k: {"spmv_dia": (1 if k == "one" else k) * (2 * r.iterations + 3)},
               true_of, torch.float32, count)
    # estimate_bounds's Lanczos (k = 40, widened by 0.1 each side) on the
    # card's products: the host oracle's took 27.9 s at this size
    t0 = time.perf_counter()
    A64 = A.device_put(torch.float64, dev)
    lo_e, hi_e = eigen.lanczos_bounds(
        lambda v: spmv_dia_cuda(A64, torch.from_numpy(v).to(dev)).cpu().numpy(), A.n, k=40)
    lo, hi = max(lo_e * 0.9, 1e-12 * hi_e), hi_e * 1.1
    del A64
    print(f"flagship padded: Chebyshev bounds [{lo:.6g}, {hi:.6g}] by Lanczos on the card's "
          f"products in {time.perf_counter() - t0:.3f} s")
    runs = {}
    for k, m in meshes.items():
        solve = make_sharded_nonsym(A, m, pol, method="chebyshev", bounds=(lo, hi),
                                    check_every=SNS_CHECK)
        _require(solve.route == "chebyshev block", f"chebyshev on {k} shards: route {solve.route}")
        runs[k] = lambda solve=solve: solve(A.data.astype(np.float32),
                                            padded.b.astype(np.float32),
                                            np.zeros(A.n, np.float32))
    runs["one"] = lambda: api.solve(A, padded.b, method="chebyshev", bounds=(lo, hi),
                                    check_every=SNS_CHECK, tol=TOL, norm="rel_l2",
                                    max_iteration=SNS_CAP, dtype=np.float32, device=dev)
    _sns_route(f"flagship padded to {A.n} chebyshev block, check_every {SNS_CHECK}", runs,
               lambda r, k: {"spmv_dia": (1 if k == "one" else k) * (r.iterations + 1)},
               lambda x: _host_rel_residual(A, padded.b, x), torch.float32, count)
    # kernel #4 at the block loop's shape: one shard's legs extended by the
    # neighbours' check_every * halo rows (sharded_chebyshev_block_loop)
    ext = extend_dia_data(shard_rows(meshes[SNS_SHARDS], A.data, torch.float32),
                          SNS_CHECK * A.bandwidth).parts[1]
    _sns_shard_kernel(f"one of {SNS_SHARDS} shards' Chebyshev-block extended DIA (check_every "
                      f"{SNS_CHECK})", DiaMatrix(ext, tuple(A.offsets), (ext.shape[1],) * 2), card)


def _sns_amg(nat, dev, card, count):
    """amg_cg and amg_bicgstab with mesh= on the preconditioners phase's
    MTX_GRID natural hierarchy (passed as hierarchy=): the sharded levels'
    products on cuSPARSE a shard, the replicated tail on its levels'
    kernels; each placed hierarchy built once for both methods.  Then
    amg_cg with SNS_AMG_MIN_LOCAL on SNS_SHARDS shards, whose tail keeps a
    stencil level on kernel #3.  Every run's launches are those its
    V-cycles imply (``_amg_cycle_launches``)."""
    from conjugategradient_tpu_torch.parallel.shard_amg import build_sharded_amg, make_sharded_amg
    from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve

    A, b, h, _ = nat
    n = A.n
    meshes = {k: make_mesh(k, devices=[dev] * k) for k in (SNS_SHARDS, 1)}
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=SNS_CAP)

    def place(k, **kw):
        t0 = time.perf_counter()
        sh = build_sharded_amg(h, meshes[k], **kw)
        torch.cuda.synchronize()
        print(f"build_sharded_amg {MTX_GRID} on {k} shard(s) {kw}: {len(sh.metas)} sharded levels "
              f"(hops, all-gather of A/R/P: "
              f"{[(mt.hops_A, mt.ag_A, mt.hops_R, mt.ag_R, mt.hops_P, mt.ag_P) for mt in sh.metas]}),"
              f" tail {[type(l.A).__name__ + str(l.A.n) for l in sh.tail.levels]} + dense "
              f"{sh.tail.coarse_inv.shape[0]}, padded to {sh.n_pad}; host setup "
              f"{time.perf_counter() - t0:.3f} s [{card}]")
        return sh

    placed = {k: place(k) for k in meshes}
    A_dev = A.device_put(torch.float32, dev)
    b_dev = torch.from_numpy(np.asarray(b, np.float32)).to(dev)
    M1 = amg.amg_preconditioner(h)
    one_cycle = _amg_cycle_launches(h)

    def route(method, placements, tag):
        runs, tails = {}, {}
        for k, sh in placements.items():
            solve, _, n_pad = make_sharded_amg(h, n, meshes[k], pol, method=method, sharded=sh)
            bp = torch.zeros(n_pad, dtype=torch.float32, device=dev)
            bp[:n] = b_dev
            runs[k] = lambda solve=solve, bp=bp: _amg_unpad(solve(bp, torch.zeros_like(bp)), n)
            tails[k] = _amg_cycle_launches(sh.tail)
        runs["one"] = ((lambda: cg_solve(A_dev, b_dev, policy=pol, M=M1)) if method == "cg"
                       else (lambda: bicgstab_solve(A_dev, b_dev, policy=pol, M=M1)))

        def want(r, k):
            # cycles: cg one at the start and one an iteration, bicgstab two
            # an iteration; one device adds the outer products on #4
            cycles = r.iterations + 1 if method == "cg" else 2 * r.iterations
            per = one_cycle if k == "one" else tails[k]
            outer = (r.iterations + 1 if method == "cg" else 1 + 2 * r.iterations) \
                if k == "one" else 0
            return {"spmv_dia": cycles * per["spmv_dia"] + outer, "#3": cycles * per["#3"],
                    "spmv_const_stencil": cycles * per["spmv_const_stencil"]}

        print(f"{tag}: a V-cycle's launches, one device {one_cycle}, each placement's tail "
              f"{tails}")
        _sns_route(tag, runs, want, lambda x: _host_rel_residual(A, b, x), torch.float32, count)

    for method in ("cg", "bicgstab"):
        route(method, placed, f"Poisson {MTX_GRID} .mtx natural amg_{method}")
    deep = place(SNS_SHARDS, min_local=SNS_AMG_MIN_LOCAL)
    _require(_amg_cycle_launches(deep.tail)["#3"] > 0,
             f"min_local {SNS_AMG_MIN_LOCAL}: the tail keeps no stencil level")
    route("cg", {SNS_SHARDS: deep, 1: placed[1]},
          f"Poisson {MTX_GRID} .mtx natural amg_cg min_local {SNS_AMG_MIN_LOCAL}")


def _amg_unpad(res, n):
    return dataclasses.replace(res, x=res.x[:n])


def _sharded_nonsym(nat, fsys, dev, card, count):
    """The sharded nonsymmetric family and the distributed AMG on
    SNS_SHARDS shards of the card and on 1, beside one device; each step's
    seconds."""
    walls = {}
    for step, args in ((_sns_convection, (dev, card, count)),
                       (_sns_helmholtz, (dev, card, count)),
                       (_sns_flagship, (fsys, dev, card, count)),
                       (_sns_amg, (nat, dev, card, count))):
        t0 = time.perf_counter()
        walls[step.__name__] = step(*args)
        print(f"  {step.__name__[len('_sns_'):]}: {time.perf_counter() - t0:.1f} s")
    print(f"sharded nonsymmetric: {SNS_SHARDS} shards on one card measure what sharding costs, "
          f"not multi-GPU speed: warm mg_bicgstab walls {walls['_sns_convection']}")


# ---------------------------------------------------------------------------
# rung 5: Poisson 511^3 assembled slab by slab onto four shards of the card,
# its hierarchy probed on the shards, MGCG; the probed build against the host
# build; rediscretized convection; kernel #3 on one rung-5 shard's slab
# ---------------------------------------------------------------------------

R5_SHARDS = 4
#: padded to 512 x 511 x 511 on four shards: 133,432,831 real rows
R5_GRID = (511, 511, 511)
#: the probed build against the host build (whose setup takes 5.7-11.3 s
#: on the H100 machines' hosts at 127^3)
R5_BUILD_GRID = (127, 127, 127)
#: fp32 probed legs, inv_diag and coarse inverse against the host build's
#: (its Galerkin products in fp64, cast): max |diff| <= this x max |host|
R5_LEG_REL = 1e-5
R5_INV_REL = 1e-3
R5_CONV_GRID = (256, 256, 256)
R5_CONV_EPS = 0.05
R5_CONV_TOL = 1e-5
#: its true fp64 relative residual: fp32 BiCGStab's recurrence residual
#: drifts from the true one (9.612e-6 against 9.633e-6 on an H100), so the
#: bound sits at twice the tolerance
R5_CONV_TRUE = 2 * R5_CONV_TOL
R5_CONV_REPS = 3
R5_SLAB_REPS = 20


def _r5_true_rel(x: Shards, legs64, b64, shifts, real0: int) -> float:
    """The true fp64 relative residual ||b - A x|| / ||b|| on the real rows
    (axis-0 rows below ``real0``), computed on the card shard by shard:
    each shard's x with one neighbour plane each side (zero at the global
    edges) in fp64, ``legs64(i)`` / ``b64(i)`` its fp64 legs and b, the
    product by kernel #3's plain twin on the extended slab."""
    num, n0 = x.mesh.size, x.shape[0]
    rr = bb = 0.0
    for i, dv in enumerate(x.mesh.devices):
        rows = min(n0, real0 - i * n0)
        if rows <= 0:
            continue
        zero = torch.zeros_like(x.parts[i][:1])
        xe = torch.cat([x.parts[i - 1][-1:].to(dv) if i else zero, x.parts[i],
                        x.parts[i + 1][:1].to(dv) if i + 1 < num else zero]).double()
        legs = extend_grid_rows(legs64(i), 1)
        y = spmv_stencil_ref(StencilMatrix(legs, shifts, tuple(xe.shape)), xe)[1:-1]
        b = b64(i)
        r = (b - y)[:rows]
        rr += float((r * r).sum())
        bb += float((b[:rows] * b[:rows]).sum())
        del xe, legs, y, r
    return float(np.sqrt(rr / bb))


def _r5_levels(h) -> list:
    """(grid, legs, transfer, where) of every level of a ``ShardHierarchy``."""
    out = [(L.grid, len(L.op.shifts), L.kind, f"sharded, {L.op.local[0]} rows a shard, halo "
            f"{L.op.halo}") for L in h.levels]
    out += [(L.grid, len(L.A.shifts), L.transfer, "replicated") for L in h.tail.levels]
    return out


def _r5_tail_products(h, smoother_sweeps) -> int:
    """Kernel #3's launches of one replicated-tail cycle: each tail level's
    products (its smoothing, the residual), once on the first device."""
    return sum(smoother_sweeps(h.pre) + smoother_sweeps(h.post) + 1 for _ in h.tail.levels)


def _r5_sweeps(h):
    return lambda n: 0 if n <= 0 else {"chebyshev": 1 + n}.get(h.smoother, n)


def _r5_poisson(mesh, dev, card, count):
    """(a): 511^3 Poisson MGCG on four shards of the card."""
    tag = f"rung 5 Poisson {R5_GRID}"
    tracemalloc.start()
    t0 = time.perf_counter()
    A, b, x0, padded, n_real = rung5.make_rung5_system(R5_GRID, mesh, dtype=np.float32)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    _, peak = tracemalloc.get_traced_memory()
    tracemalloc.stop()
    n = int(np.prod(padded))
    n_local = n // R5_SHARDS
    global_bytes = (len(A.shifts) + 1) * n * 4
    two_slabs = 2 * (len(A.shifts) + 1) * n_local * 4
    g0 = -(-R5_GRID[0] // R5_SHARDS) * R5_SHARDS
    _require(n_real == int(np.prod(R5_GRID)) and padded == (g0,) + R5_GRID[1:],
             f"{tag}: padded {padded}, {n_real} real rows")
    _require(peak < two_slabs, f"{tag}: the assembly's peak host bytes {peak} >= two shards' "
                                f"slabs {two_slabs}")
    print(f"{tag}: padded to {padded} on {R5_SHARDS} shards of the card, {n_real:,} real rows; "
          f"assembled slab by slab in {t_asm:.3f} s, peak host bytes {peak:,} (tracemalloc) "
          f"against {global_bytes:,} for the global legs + b and {two_slabs:,} for two shards' "
          f"slabs [{card}]")

    _reset_counts()
    t0 = time.perf_counter()
    h = build_hierarchy_probed(A, mesh)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    got, want = _k3_launches(), sum(s * p for _, s, p in h.setup_products)
    _require(got == want, f"{tag} probed setup: {got} kernel #3 launches, the code implies {want}")
    count(f"{tag} probed setup", {"spmv_stencil": spmv_stencil_cuda.launches,
                                  "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
    _require(len(h.levels) >= 1, f"{tag}: no sharded level")
    print(f"{tag} probed setup on the card: {t_setup:.3f} s (by phase "
          f"{ {k: round(v, 3) for k, v in h.setup_s.items()} }); levels (grid, legs, transfer, "
          f"where) {_r5_levels(h)} + dense {h.coarse_inv.shape[0]}; kernel #3 launches {got} = "
          f"{want} implied (shards x (probes + power iterations + 2) a level: "
          f"{[(g, s, p) for g, s, p in h.setup_products]}); device-to-host reads "
          f"{h.host_reads} [{card}]")
    print(f"{tag} probed setup's near-null choice, per coarsened level (grid, Rayleigh quotient "
          f"of the constant, of the checkerboard, transfer; fp32 on the card): "
          f"{[(g, f'{q1:.9e}', f'{q2:.9e}', k) for g, q1, q2, k in h.near_null]} [{card}]")

    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    _require(h.real0 == R5_GRID[0], f"{tag}: the hierarchy's real rows {h.real0}")
    solve = rung5.make_rung5_mgcg(pol, h)
    _reset_counts()
    t0 = time.perf_counter()
    res = solve(b, x0)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    _require(res.converged, f"{tag}: MGCG did not converge in {res.iterations} iterations")
    got = _k3_launches()
    want = _smg_want("cg", res.iterations, 1, solve.plan, R5_SHARDS,
                     _r5_tail_products(h, _r5_sweeps(h)))
    _require(got == want, f"{tag} MGCG: {got} kernel #3 launches, the recurrence implies {want}")
    count(f"{tag} MGCG", {"spmv_stencil": spmv_stencil_cuda.launches,
                          "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
    real0, n0 = R5_GRID[0], padded[0] // R5_SHARDS
    pad = res.x.parts[-1][real0 - (R5_SHARDS - 1) * n0:]
    _require(bool((pad == 0).all()), f"{tag}: the padded plane of x is not exactly 0")
    t0 = time.perf_counter()
    rel = _r5_true_rel(res.x, lambda i: A.data.parts[i].double(),
                       lambda i: _r5_poisson_b64(R5_GRID, i, n0, dev),
                       A.shifts, real0)
    t_chk = time.perf_counter() - t0
    _require(rel <= TRUE_REL, f"{tag}: true fp64 relative residual {rel:.3e} > {TRUE_REL}")
    print(f"{tag} MGCG (rung5.make_rung5_mgcg, the padded plane masked): {res.iterations} "
          f"iterations, rel_l2 {float(res.residual):.3e}, true fp64 relative residual on the real "
          f"rows {rel:.3e} (on the card by shard, {t_chk:.3f} s), padded plane exactly 0; kernel "
          f"#3 launches {got} = {want} implied ({solve.plan.products_per_cycle} sharded products "
          f"a V-cycle); first call {t_first:.3f} s [{card}]")
    fn = lambda: solve(b, x0)
    walls = _wall_median_ms(fn)
    busy = _par_profile(f"{tag} MGCG", fn, walls[0], card)
    print(f"time {tag} MGCG on {R5_SHARDS} shards: warm wall {_fmt_wall(walls)}, device busy "
          f"{busy:.1%}, {res.iterations} iterations; setup {t_setup:.3f} s, assembly {t_asm:.3f} s "
          f"[{card}]")
    return h, A


def _r5_poisson_b64(grid, i, n0, dev) -> torch.Tensor:
    """Shard i's rows of the rung-5 Poisson right-hand side in fp64 on the
    card: ``poisson_rhs_slab``'s closed form (0 on the padded plane)."""
    lo = i * n0
    d = len(grid)
    strides = np.cumprod((1,) + tuple(grid[:0:-1]))[::-1]
    idx = torch.zeros((), dtype=torch.float64, device=dev)
    for ax in range(d):
        n_ax = n0 if ax == 0 else grid[ax]
        t = torch.arange(n_ax, device=dev, dtype=torch.float64) + (lo if ax == 0 else 0)
        idx = idx + (t * float(strides[ax])).reshape([-1 if k == ax else 1 for k in range(d)])
    vals = torch.sin(0.37 * idx + SEED) + 0.25 * torch.cos(1.3 * idx)
    real = (torch.arange(n0, device=dev) + lo < grid[0]).reshape((-1,) + (1,) * (d - 1))
    return torch.where(real, vals, torch.zeros((), dtype=torch.float64, device=dev))


def _r5_slab_kernel(h, dev, card, times):
    """(d): kernel #3 on one of the four shards' extended fine slabs of the
    rung-5 hierarchy (the legs the solve holds), against its twin, timed
    beside its bound and cuSPARSE's CSR product of the same slab."""
    op = h.levels[0].op
    A = op.mats.parts[1]
    gen = torch.Generator(device=dev).manual_seed(SEED + 51)
    x = torch.randn(A.grid, generator=gen, device=dev)
    y = spmv_stencil_cuda(A, x)
    ref = spmv_stencil_ref(A, x)
    err, scale = _max_err(y, ref)
    _require(err <= KERNEL_REL * scale, f"rung-5 slab #3: max err {err:.3e} against the twin")
    del ref
    k_ms = time_ms(lambda: spmv_stencil_cuda(A, x), R5_SLAB_REPS)
    p_ms = time_ms(lambda: spmv_stencil_ref(A, x), 3)
    csr = _stencil_csr(A)
    lib_ms = _library("spmv_stencil rung-5 shard slab", lambda: csr @ x.reshape(-1),
                      y.reshape(-1), card, R5_SLAB_REPS)
    del csr
    nbytes = A.nnz * 4 + 2 * x.numel() * 4
    bound = bound_ms(nbytes, 2 * A.nnz)
    times["rung5 slab"] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1],
                               library_ms=lib_ms, shape=list(A.grid), legs=A.nlegs)
    print(f"time spmv_stencil on one of {R5_SHARDS} shards' extended rung-5 slab "
          f"{tuple(A.grid)} x {A.nlegs} legs fp32: max err against the twin {err:.3e}; kernel "
          f"{k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms by {bound[1]}, "
          f"{bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms, CSR {lib_ms:.4f} ms [{card}]")
    return err


def _r5_build_vs_host(mesh, dev, card, count):
    """(b): the probed build against the port's host build
    (``build_hierarchy(sa_smooth_levels=0, layout="stencil")``) on one
    grid, fp32 (``scripts.probed_setup_bench.probed_vs_host``): the same
    level grids and transfers, legs within R5_LEG_REL, both setup times,
    both MGCG counts within one."""
    grid = R5_BUILD_GRID
    tag = f"rung 5 probed vs host build {grid}"
    out = probed_vs_host(grid, mesh, ConvergencePolicy(tol=TOL, norm="rel_l2"))
    hp, hh, res_p, res_h = out["h"], out["host_h"], out["res"], out["host_res"]
    probed = [(L.grid, L.kind, L.op.shifts,
               torch.cat([m.data[:, L.op.halo:L.op.halo + L.op.local[0]] for m in L.op.mats.parts],
                         dim=1), L.inv_diag.gather(0), L.bounds) for L in hp.levels]
    probed += [(L.grid, L.transfer, L.A.shifts, L.A.data, L.inv_diag, L.cheb_bounds)
               for L in hp.tail.levels]
    _require([(g, k) for g, k, *_ in probed] == [(L.grid, L.transfer) for L in hh.levels],
             f"{tag}: levels {[(g, k) for g, k, *_ in probed]} against the host's "
             f"{[(L.grid, L.transfer) for L in hh.levels]}")
    rows = []
    for (g, k, shifts, legs, inv, bounds), L in zip(probed, hh.levels):
        host = dict(zip(L.A.shifts, L.A.data))
        mine = dict(zip(shifts, legs))
        scale = max(float(v.abs().max()) for v in host.values())
        _require(set(host) <= set(mine), f"{tag} {g}: probed legs lack {set(host) - set(mine)}")
        extra = max((float(mine[s].abs().max()) for s in set(mine) - set(host)), default=0.0)
        d_leg = max(float((mine[s] - host[s].to(mine[s].device)).abs().max()) for s in host)
        d_inv = float((inv.reshape(-1) - L.inv_diag.reshape(-1).to(inv.device)).abs().max())
        _require(max(d_leg, extra) <= R5_LEG_REL * scale,
                 f"{tag} {g}: legs differ by {d_leg:.3e}, extra legs up to {extra:.3e}")
        _require(d_inv <= R5_LEG_REL * float(L.inv_diag.abs().max()), f"{tag} {g}: inv_diag "
                                                                      f"differs by {d_inv:.3e}")
        rows.append((g, k, len(mine), len(host), f"{d_leg:.2e}", f"{d_inv:.2e}",
                     tuple(round(v, 5) for v in bounds), tuple(round(v, 5) for v in L.cheb_bounds)))
    d_ci = float((hp.coarse_inv - hh.coarse_inv.to(hp.coarse_inv.device)).abs().max())
    _require(d_ci <= R5_INV_REL * float(hh.coarse_inv.abs().max()),
             f"{tag}: coarse inverses differ by {d_ci:.3e}")
    _require(res_p.converged and res_h.converged
             and abs(res_p.iterations - res_h.iterations) <= 1,
             f"{tag}: probed MGCG {res_p.iterations} iterations against the host build's "
             f"{res_h.iterations}")
    print(f"{tag} (padded {out['padded']}, fp32, {R5_SHARDS} shards): probed setup "
          f"{out['setup_s']:.3f} s on the card against the host build's {out['host_setup_s']:.3f}"
          f" s (by phase { {k: round(v, 3) for k, v in hh.setup_s.items()} }); levels (grid, "
          f"transfer, legs probed, legs host, max |leg diff|, max |inv_diag diff|, probed bounds, "
          f"host bounds) {rows}; coarse inverse diff {d_ci:.3e}; near-null quotients "
          f"{[(g, f'{q1:.6e}', f'{q2:.6e}', k) for g, q1, q2, k in hp.near_null]}; MGCG "
          f"{res_p.iterations} iterations on the probed hierarchy, {res_h.iterations} on the "
          f"host's [{card}]")
    return out["setup_s"], out["host_setup_s"]


def _r5_convection(mesh, dev, card, count):
    """(c): rediscretized convection 256^3 by mg BiCGStab on four shards."""
    grid = R5_CONV_GRID
    tag = f"rung 5 convection {grid} eps {R5_CONV_EPS}"
    t0 = time.perf_counter()
    A, b, x0 = rung5.make_convection_system(grid, mesh, eps=R5_CONV_EPS, dtype=np.float32)
    torch.cuda.synchronize()
    t_asm = time.perf_counter() - t0
    slab = generators.convection_diffusion_level_slab(R5_CONV_EPS, dtype=np.float32)
    _reset_counts()
    t0 = time.perf_counter()
    h = build_hierarchy_redisc(grid, mesh, slab, smoother="jacobi", dtype=np.float32)
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    got, want = _k3_launches(), sum(s * p for _, s, p in h.setup_products)
    _require(got == want, f"{tag} redisc setup: {got} kernel #3 launches, the code implies {want}")
    count(f"{tag} redisc setup", {"spmv_stencil": spmv_stencil_cuda.launches,
                                  "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
    pol = ConvergencePolicy(tol=R5_CONV_TOL, norm="rel_l2")
    solve = rung5.make_rung5_mg_nonsym(pol, h, "bicgstab")
    _reset_counts()
    t0 = time.perf_counter()
    res = solve(b, x0)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    _require(res.converged, f"{tag}: mg BiCGStab did not converge in {res.iterations} iterations")
    its = res.iterations
    got = _k3_launches()
    want = (R5_SHARDS * (1 + 2 * its + 2 * its * solve.plan.products_per_cycle)
            + 2 * its * _r5_tail_products(h, _r5_sweeps(h)))
    _require(got == want, f"{tag}: {got} kernel #3 launches, the recurrence implies {want}")
    count(f"{tag} mg BiCGStab", {"spmv_stencil": spmv_stencil_cuda.launches,
                                 "spmv_stencil_wide": spmv_stencil_wide_cuda.launches})
    slab64 = generators.convection_diffusion_level_slab(R5_CONV_EPS, dtype=np.float64)
    n0 = grid[0] // R5_SHARDS
    rel = _r5_true_rel(
        res.x, lambda i: torch.from_numpy(slab64(0, grid, i * n0, (i + 1) * n0)).to(dev),
        lambda i: torch.from_numpy(generators.convection_diffusion_rhs_slab(
            grid, i * n0, (i + 1) * n0, dtype=np.float64)).to(dev), A.shifts, grid[0])
    _require(rel <= R5_CONV_TRUE, f"{tag}: true fp64 relative residual {rel:.3e} > "
                                  f"{R5_CONV_TRUE}")
    fn = lambda: solve(b, x0)
    walls = _wall_median_ms(fn, R5_CONV_REPS)
    print(f"{tag} (rung5.make_rung5_mg_nonsym BiCGStab, build_hierarchy_redisc Jacobi, levels "
          f"{_r5_levels(h)} + dense {h.coarse_inv.shape[0]}): {its} iterations, rel_l2 "
          f"{float(res.residual):.3e}, true fp64 relative residual {rel:.3e}; kernel #3 launches "
          f"{got} = {want} implied; assembly {t_asm:.3f} s, setup {t_setup:.3f} s, first call "
          f"{t_first:.3f} s, warm wall {_fmt_wall(walls, R5_CONV_REPS)} [{card}]")


def _rung5(dev, card, count, errs, times):
    """The rung-5 phase: (a) 511^3 Poisson MGCG on four shards of the card
    (slab-by-slab assembly, the probed setup, the masked MGCG), (d) kernel
    #3 on one of its shards' slabs, (b) the probed build against the host
    build, (c) the rediscretized 256^3 convection by mg BiCGStab."""
    mesh = make_mesh(R5_SHARDS, devices=[dev] * R5_SHARDS)
    t0 = time.perf_counter()
    h, A = _r5_poisson(mesh, dev, card, count)
    print(f"phase: rung 5 (a) in {time.perf_counter() - t0:.1f} s")
    errs["spmv_stencil"] = max(errs["spmv_stencil"], _r5_slab_kernel(h, dev, card, times))
    del h, A
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _r5_build_vs_host(mesh, dev, card, count)
    print(f"phase: rung 5 (b) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _r5_convection(mesh, dev, card, count)
    print(f"phase: rung 5 (c) in {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the eigensolvers over a mesh and the 2-D block partitions
# ---------------------------------------------------------------------------

M2_SHARDS = 4
#: LOBPCG through api.eigs(mesh=) on Poisson M2_EIG_GRID in fp32, M the
#: sharded V-cycle on each shard's (k, n / 4) rows
M2_EIG_GRID = (1024, 1024)
M2_EIG_K = 8
#: gspmd_arnoldi_eigs LM on convection-diffusion M2_ARN_GRID eps CD_EPS in
#: fp32 at the eigensolvers phase's tol.  The top of this nonnormal
#: spectrum is a cluster (moduli 3.1137-3.1241, a CPU run) in which two
#: fp32 runs of different rounding converge to different Ritz pairs (the
#: 4-shard and the one-device sets 8.2e-2 apart as sets on the card, each
#: pair with a true residual at its bound), so the runs are held to each
#: other by the largest modulus, relative (M2_ARN_AGREE: the cluster's
#: moduli span 3.3e-3 of it; the card's two runs 2.5e-3 apart, the CPU's
#: 2.6e-5), and each to its true residuals.  m = 48: at CD_M = 32 neither the
#: one-device nor the 4-shard fp32 run reaches 2e-6 at 512^2 in 60 restarts
#: (CPU runs: 3.4e-5 and 1.5e-5 relative; the 4-shard run on the card too),
#: at 48 both do (749 and 664 matvecs on the CPU)
M2_ARN_GRID = (512, 512)
M2_ARN_K = 6
M2_ARN_M = 48
M2_ARN_TOL = 2e-6
M2_ARN_AGREE = 1e-2
#: the (2, 2) mesh of the 2-D block partitions
M2_DIMS = (2, 2)
#: gspmd_refined_solve on jump diffusion M2_REF_GRID to a true fp64 ||r||_2
M2_REF_GRID = (512, 512)
M2_REF_TOL = 1e-10
#: PR 19's and PR 20's 4-shard 1-D counts, printed beside this run's
M2_1D_BEFORE = {"gspmd_mgcg Poisson 256^3": 5, "mg_bicgstab convection 1024^2": 11}
M2_REPS = 3
#: mg_bicgstab's profiled window: one iteration (a 3-iteration window's
#: 11,257 device ops took 10.4 s to trace and read on the card)
M2_WINDOW = 1
#: the probed builds compared on 256^3 by plain aggregation: 27 probes a
#: level, where the hybrid transfers' cell-centred levels take 125 (8.8 and
#: 9.3 s a build on the card, against the phase's 90-s budget)
M2_PROBED_KIND = "agg"


def _m2_mesh(dev) -> Mesh:
    return Mesh([[dev] * M2_DIMS[1]] * M2_DIMS[0], ("x", "y"))


def _m2_lobpcg(dev, card, count):
    """``api.eigs(mesh=)`` by LOBPCG on Poisson M2_EIG_GRID, k = M2_EIG_K,
    the sharded V-cycle as M: #5 four times per pass (once a shard), the
    values against the closed form and the one-device ``lobpcg`` (the
    one-device block V-cycle) within their Rayleigh-quotient bounds, true
    residuals, warm walls of both."""
    from conjugategradient_tpu_torch.solvers.lobpcg import gspmd_lobpcg, lobpcg

    k, g = M2_EIG_K, M2_EIG_GRID
    s = generators.poisson_system(g)
    A = s.A
    csr = to_scipy(A).tocsr()
    exact = _poisson_closed_form(g, k + 4)
    distinct = np.unique(np.round(exact, 12))
    m4 = make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS)
    tag = f"eigs lobpcg on {M2_SHARDS} shards Poisson {g} k={k} SM sharded V-cycle fp32"
    _reset_counts()
    t0 = time.perf_counter()
    r = api.eigs(A, k=k, which="SM", grid=g, mesh=m4, spd=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = _eig_counts()
    its = r.restarts
    _require(r.converged, f"{tag}: not converged in {its} iterations")
    per_shard = len(k_chunks(k)) + its * len(k_chunks(3 * k))
    _require(got["spmm_dia"] == M2_SHARDS * per_shard,
             f"{tag}: {got['spmm_dia']} spmm_dia launches, {M2_SHARDS} x {per_shard} implied")
    _require(got["spmv_stencil"] + got["spmv_stencil_wide"] > 0, f"{tag}: no V-cycle #3 launch")
    count(f"mesh eigensolvers: {tag}", got)
    lam, X = r.values.real, r.vectors.real
    true = _true_pair_residuals(csr, X, lam)
    ratio = _check_true(tag, true, r.residuals, _floor(A, torch.float32, lam))
    bound = _rq_bounds(csr, X, lam, distinct)
    closed = np.abs(lam - exact[:k])
    _require(np.all(closed <= bound + 1e-12 * exact[:k]),
             f"{tag}: |values - closed form| {closed} beyond the Rayleigh-quotient bounds {bound}")
    M = api._eig_vcycle(A, g, torch.float32, dev, m4)
    M1 = api._eig_vcycle(A, g, torch.float32, dev, None)
    t1 = time.perf_counter()
    r1 = lobpcg(A, k, M=M1, tol=1e-5, device=dev)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t1
    _require(r1.converged, f"{tag}: the one-device lobpcg did not converge")
    lam1 = r1.eigenvalues.double().cpu().numpy()
    bound1 = _rq_bounds(csr, r1.eigenvectors.double().cpu().numpy(), lam1, distinct)
    diff = np.abs(lam - lam1)
    _require(np.all(diff <= bound + bound1), f"{tag}: against the one-device lobpcg {diff} beyond "
             f"{bound + bound1}")
    w4 = _wall_ms(lambda: gspmd_lobpcg(A, k, m4, M=M, tol=1e-5))
    w1 = _wall_ms(lambda: lobpcg(A, k, M=M1, tol=1e-5, device=dev))
    print(f"{tag}: {its} iterations (one-device lobpcg {r1.iterations}), values "
          f"{np.array2string(lam, precision=8)}, |values - closed form| max "
          f"{closed.max():.3e} within the Rayleigh-quotient bounds (max {bound.max():.3e}), "
          f"against the one-device values max {diff.max():.3e}; true residuals worst "
          f"{true.max():.3e} (true/reported {ratio:.3f}); spmm_dia launches {got['spmm_dia']} = "
          f"{M2_SHARDS} x {per_shard} ({per_shard} a shard), V-cycle #3 launches "
          f"{got['spmv_stencil']} tuned + {got['spmv_stencil_wide']} wide; wall with the setup "
          f"{wall:.3f} s (one-device lobpcg's first call {wall1:.3f} s); warm gspmd_lobpcg "
          f"{w4:.3f} ms, one-device lobpcg {w1:.3f} ms on the same M [{card}]")


def _m2_arnoldi(dev, card, count):
    """``gspmd_arnoldi_eigs`` LM on convection-diffusion M2_ARN_GRID: #4 four
    times a matvec (once a shard), both runs' true residuals, the largest
    modulus against the one-device ``arnoldi_eigs``'s at the same m and tol
    (M2_ARN_AGREE), warm walls."""
    from conjugategradient_tpu_torch.solvers.arnoldi import arnoldi_eigs, gspmd_arnoldi_eigs

    g = M2_ARN_GRID
    A = generators.convection_diffusion_matrix(g, eps=CD_EPS)
    csr = to_scipy(A).tocsr()
    m4 = make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS)
    kw = dict(k=M2_ARN_K, which="LM", tol=M2_ARN_TOL, m=M2_ARN_M, precise_dot=True,
              dtype=torch.float32)
    tag = (f"gspmd_arnoldi_eigs on {M2_SHARDS} shards convection {g} eps {CD_EPS} LM "
           f"k={M2_ARN_K} tol {M2_ARN_TOL} m={M2_ARN_M} fp32")
    _reset_counts()
    r = gspmd_arnoldi_eigs(A, mesh=m4, **kw)
    torch.cuda.synchronize()
    got = _eig_counts()
    _require(r.converged, f"{tag}: not converged in {r.restarts} restarts")
    _require(got["spmv_dia"] == M2_SHARDS * r.matvecs,
             f"{tag}: {got['spmv_dia']} spmv_dia launches for {r.matvecs} matvecs on "
             f"{M2_SHARDS} shards")
    count(f"mesh eigensolvers: {tag}", got)
    true = _true_pair_residuals(csr, r.vectors, r.values)
    ratio = _check_true(tag, true, r.residuals,
                        _floor(A, torch.float32, r.values) * np.sqrt(M2_ARN_M))
    t0 = time.perf_counter()
    r1 = arnoldi_eigs(A, device=dev, **kw)
    torch.cuda.synchronize()
    first1 = (time.perf_counter() - t0) * 1e3
    _require(r1.converged, f"{tag}: the one-device run did not converge")
    true1 = _true_pair_residuals(csr, r1.vectors, r1.values)
    _check_true(f"{tag} (one device)", true1, r1.residuals,
                _floor(A, torch.float32, r1.values) * np.sqrt(M2_ARN_M))
    diff = float(np.max(np.abs(_as_set(r.values) - _as_set(r1.values))))
    scale = float(np.max(np.abs(r1.values)))
    top = abs(float(np.max(np.abs(r.values))) - scale)
    _require(top <= M2_ARN_AGREE * scale, f"{tag}: largest modulus {top:.3e} from the one-device "
             f"run's {scale:.6f}")
    w4 = _wall_ms(lambda: gspmd_arnoldi_eigs(A, mesh=m4, **kw))
    w1 = _wall_ms(lambda: arnoldi_eigs(A, device=dev, **kw))
    print(f"{tag}: {r.matvecs} matvecs, {r.restarts} restarts (one device {r1.matvecs}, "
          f"{r1.restarts}), values {np.array2string(r.values, precision=7)} (one device "
          f"{np.array2string(r1.values, precision=7)}), max |diff| as sets {diff:.2e}, largest "
          f"moduli {top:.2e} apart (of {scale:.6f}); true fp64 residuals worst {true.max():.2e} "
          f"(true/reported {ratio:.3f}); spmv_dia launches {got['spmv_dia']} = {M2_SHARDS} x "
          f"{r.matvecs}; warm walls {w4:.3f} ms on {M2_SHARDS} shards, {w1:.3f} ms on one "
          f"device (its first call {first1:.3f} ms) [{card}]")


def _m2_solve_pair(tag, runs, true_of, count, card, fp32=True):
    """The 1-D and 2-D runs of one route, each counted from a reset: both
    converged, equal counts, true residuals; returns the results."""
    out = {}
    for name, fn in runs.items():
        _reset_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = _eig_counts()
        _require(bool(res.converged), f"{tag} {name}: not converged")
        true = true_of(res)
        count(f"2-D blocks: {tag} {name}", got, fp32=fp32)
        out[name] = (res, got, wall, true)
        nz = {k: v for k, v in got.items() if v}
        print(f"{tag} {name}: {_its(res)} iterations, true residual {true:.3e}, first call "
              f"{wall:.3f} s; launches {nz} [{card}]")
    return out


def _its(res):
    return getattr(res, "outer_iterations", None) or res.iterations


def _m2_mgcg(poisson3, dev, card, count):
    """``make_gspmd_mgcg`` on Poisson 256^3 (its Galerkin hierarchy) over
    the 1-D 4-shard mesh and the (2, 2) mesh: the same count, x within
    PAR_X_AGREE, warm walls and the 2-D solve's busy share."""
    from conjugategradient_tpu_torch.parallel.gspmd import make_gspmd_mgcg

    s3, h3 = poisson3
    g = KIND_GRID_3D
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    meshes = {"1-D (4,)": (make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS), ("x",)),
              "2-D (2, 2)": (_m2_mesh(dev), ("x", "y"))}
    solves, made = {}, {}
    for name, (mesh, axes) in meshes.items():
        t0 = time.perf_counter()
        solve, (b, x0) = make_gspmd_mgcg(s3, g, mesh, pol, axes=axes, hierarchy=h3,
                                         dtype=np.float32)
        torch.cuda.synchronize()
        made[name] = round(time.perf_counter() - t0, 3)
        _require(solve.n_sharded >= 1, f"gspmd_mgcg 256^3 {name}: did not shard")
        solves[name] = (solve, b, x0)
    tag = f"gspmd_mgcg Galerkin Poisson {g}"
    out = _m2_solve_pair(tag, {k: (lambda v=v: v[0](v[1], v[2])) for k, v in solves.items()},
                         lambda r: _host_rel_residual(s3.A, s3.b, r.x.double().cpu().numpy()),
                         count, card)
    (r1, _, _, t1), (r2, _, _, t2) = out["1-D (4,)"], out["2-D (2, 2)"]
    _require(max(t1, t2) <= TRUE_REL, f"{tag}: true residuals {t1:.3e}, {t2:.3e}")
    _require(r2.iterations == r1.iterations, f"{tag}: 2-D {r2.iterations} iterations, 1-D "
             f"{r1.iterations}")
    dx = float((r2.x - r1.x).abs().max() / r1.x.abs().max())
    _require(dx <= PAR_X_AGREE[torch.float32], f"{tag}: 2-D x {dx:.3e} from the 1-D x")
    walls = {k: _wall_median_ms(lambda v=v: v[0](v[1], v[2]), M2_REPS) for k, v in solves.items()}
    solve2, b2, x02 = solves["2-D (2, 2)"]
    busy = _par_profile(f"{tag} 2-D (2, 2)", lambda: solve2(b2, x02), walls["2-D (2, 2)"][0], card)
    plan = solve2.plan
    print(f"{tag}: 2-D {r2.iterations} iterations = 1-D {r1.iterations} (PR 19's 1-D: "
          f"{M2_1D_BEFORE['gspmd_mgcg Poisson 256^3']}), x within {dx:.3e}; 2-D plan: sharded "
          f"levels {list(plan.levels)}, tail {list(plan.tail)}, halo bytes a cycle "
          f"{plan.halo_bytes_per_cycle}, cc bytes {plan.cc_bytes_per_cycle}; warm walls "
          f"{ {k: _fmt_wall(w, M2_REPS) for k, w in walls.items()} }, 2-D busy {busy:.1%}; "
          f"make_gspmd_mgcg s (placing the levels) {made} [{card}]")
    return solve2


def _m2_mg_bicgstab(dev, card, count):
    """``api.solve(method="mg_bicgstab", mesh=, axes=)`` on convection
    SNS_GRID eps NONSYM_EPS over the 1-D and the (2, 2) mesh: the same
    count, true residuals, warm walls on one hierarchy and the 2-D
    3-iteration window's busy share."""
    from conjugategradient_tpu_torch.parallel.gspmd import make_gspmd_mg_nonsym

    g = SNS_GRID
    s = generators.convection_diffusion_system(g, eps=NONSYM_EPS)
    co = generators.convection_diffusion_coarse_operator(NONSYM_EPS)
    meshes = {"1-D (4,)": (make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS), ("x",)),
              "2-D (2, 2)": (_m2_mesh(dev), ("x", "y"))}
    opts = dict(method="mg_bicgstab", grid=g, coarse_operator=co, tol=TOL, norm="rel_l2",
                max_iteration=SNS_CAP, dtype=np.float32)
    tag = f"api.solve mg_bicgstab convection {g} eps {NONSYM_EPS}"
    out = _m2_solve_pair(tag, {k: (lambda v=v: api.solve(s.A, s.b, mesh=v[0], axes=v[1], **opts))
                               for k, v in meshes.items()},
                         lambda r: _host_rel_residual(s.A, s.b, r.x.double().cpu().numpy()),
                         count, card)
    (r1, _, _, t1), (r2, _, _, t2) = out["1-D (4,)"], out["2-D (2, 2)"]
    _require(max(t1, t2) <= TRUE_REL, f"{tag}: true residuals {t1:.3e}, {t2:.3e}")
    _require(r2.iterations == r1.iterations, f"{tag}: 2-D {r2.iterations} iterations, 1-D "
             f"{r1.iterations}")
    h = build_hierarchy(s.A, g, smoother="jacobi", coarse_operator=co, dtype=np.float32,
                        device=dev)
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2", max_iteration=SNS_CAP)
    walls, windows = {}, {}
    for name, (mesh, axes) in meshes.items():
        solve, (b, x0) = make_gspmd_mg_nonsym(s.A, s.b, g, mesh, pol, axes=axes, hierarchy=h,
                                              dtype=np.float32)
        walls[name] = _wall_median_ms(lambda: solve(b, x0), M2_REPS)
        win, (bw, xw) = make_gspmd_mg_nonsym(s.A, s.b, g, mesh,
                                             dataclasses.replace(pol, max_iteration=M2_WINDOW),
                                             axes=axes, hierarchy=h, dtype=np.float32)
        windows[name] = (win, bw, xw)
    win, bw, xw = windows["2-D (2, 2)"]
    run = lambda: win(bw, xw)
    busy = _par_profile(f"{tag} 2-D (2, 2) {M2_WINDOW}-iteration window", run, _wall_ms(run), card)
    print(f"{tag}: 2-D {r2.iterations} iterations = 1-D {r1.iterations} (PR 20's 1-D: "
          f"{M2_1D_BEFORE['mg_bicgstab convection 1024^2']}); warm walls "
          f"{ {k: _fmt_wall(w, M2_REPS) for k, w in walls.items()} }, the 2-D window's busy "
          f"{busy:.1%} [{card}]")


def _m2_refined(dev, card, count):
    """``gspmd_refined_solve`` on jump diffusion M2_REF_GRID over the 1-D
    and the (2, 2) mesh (the 2-D outer residual on kernel #3 in fp64 a
    shard, the 1-D on #4): a true fp64 ||r||_2 under M2_REF_TOL, outer
    counts within 1."""
    from conjugategradient_tpu_torch.parallel.gspmd import gspmd_refined_solve

    g = M2_REF_GRID
    s = generators.diffusion_system(g, kind="jump")
    h = build_hierarchy(s.A, g, smoother="chebyshev", layout="stencil", dtype=np.float32,
                        device=dev)
    meshes = {"1-D (4,)": (make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS), ("x",)),
              "2-D (2, 2)": (_m2_mesh(dev), ("x", "y"))}
    tag = f"gspmd_refined_solve jump diffusion {g} tol {M2_REF_TOL}"
    true_of = lambda r: float(np.linalg.norm(s.b - oracle.spmv(s.A, r.x)))
    out = _m2_solve_pair(tag, {k: (lambda v=v: gspmd_refined_solve(
        s.A, s.b, g, mesh=v[0], axes=v[1], tol=M2_REF_TOL, hierarchy=h))
        for k, v in meshes.items()}, true_of, count, card, fp32=False)
    (r1, g1, _, t1), (r2, g2, _, t2) = out["1-D (4,)"], out["2-D (2, 2)"]
    _require(max(t1, t2) < M2_REF_TOL, f"{tag}: true ||r||_2 {t1:.3e}, {t2:.3e}")
    _require(abs(r2.outer_iterations - r1.outer_iterations) <= 1,
             f"{tag}: outer passes {r2.outer_iterations} (2-D) against {r1.outer_iterations}")
    _require(g2["spmv_dia"] == 0 and g1["spmv_dia"] == M2_SHARDS * (r1.outer_iterations + 1),
             f"{tag}: #4 launches {g1['spmv_dia']} (1-D), {g2['spmv_dia']} (2-D)")
    print(f"{tag}: outer {r2.outer_iterations} (2-D) / {r1.outer_iterations} (1-D), inner "
          f"{r2.inner_iterations} / {r1.inner_iterations}, true ||r||_2 {t2:.3e} / {t1:.3e}; the "
          f"2-D fp64 outer residual on #3 ({M2_SHARDS} x {r2.outer_iterations + 1} of its "
          f"{g2['spmv_stencil']} launches), no #4 [{card}]")


def _m2_legs(op) -> torch.Tensor:
    """A sharded level's global legs from its ``HaloStencil``: each shard's
    block of its extended legs, gathered."""
    blocks = Shards([op._narrowed(m.data, range(len(op.halos))) for m in op.mats.parts], op.mesh)
    return blocks.gather_grid(len(op.local))


def _m2_probed(poisson3, dev, card, count):
    """``build_hierarchy_probed`` on Poisson 256^3 fp32 over the 1-D and the
    (2, 2) mesh: the same levels, transfers and shifts, legs bit for bit,
    the same tail; MGCG on each at the same count."""
    s3 = poisson3[0]
    g = KIND_GRID_3D
    st = dia_to_stencil(s3.A, g)
    A32 = StencilMatrix(torch.from_numpy(st.data.astype(np.float32)), st.shifts, g)
    meshes = {"1-D (4,)": (make_mesh(M2_SHARDS, devices=[dev] * M2_SHARDS), ("x",)),
              "2-D (2, 2)": (_m2_mesh(dev), ("x", "y"))}
    hs, secs = {}, {}
    for name, (mesh, axes) in meshes.items():
        _reset_counts()
        t0 = time.perf_counter()
        hs[name] = build_hierarchy_probed(A32, mesh, axes=axes, transfer_kind=M2_PROBED_KIND)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        count(f"2-D blocks: probed setup Poisson {g} {name}", _eig_counts())
    h1, h2 = hs["1-D (4,)"], hs["2-D (2, 2)"]
    tag = f"build_hierarchy_probed Poisson {g} fp32 transfer_kind={M2_PROBED_KIND!r}"
    _require([(L.grid, L.kind, L.op.shifts) for L in h1.levels]
             == [(L.grid, L.kind, L.op.shifts) for L in h2.levels]
             and [L.grid for L in h1.tail.levels] == [L.grid for L in h2.tail.levels],
             f"{tag}: the 2-D levels differ from the 1-D build's")
    for L1, L2 in zip(h1.levels, h2.levels):
        _require(torch.equal(_m2_legs(L1.op), _m2_legs(L2.op)),
                 f"{tag}: level {L1.grid}'s 2-D legs differ from the 1-D build's")
    for L1, L2 in zip(h1.tail.levels, h2.tail.levels):
        _require(torch.equal(L1.A.data, L2.A.data), f"{tag}: tail {L1.grid} differs")
    pol = ConvergencePolicy(tol=TOL, norm="rel_l2")
    its = {}
    for name, (mesh, _axes) in meshes.items():
        solve, (b, x0) = make_shard_mgcg(s3, g, mesh, pol, hierarchy=hs[name], dtype=np.float32)
        res = solve(b, x0)
        _require(res.converged, f"{tag} {name}: MGCG did not converge")
        its[name] = res.iterations
    _require(its["2-D (2, 2)"] == its["1-D (4,)"], f"{tag}: MGCG counts {its}")
    print(f"{tag}: levels {[(L.grid, L.kind, len(L.op.shifts)) for L in h2.levels]} + tail "
          f"{[L.grid for L in h2.tail.levels]}, legs bit-equal to the 1-D build's; setup s "
          f"{ {k: round(v, 3) for k, v in secs.items()} }; MGCG iterations {its} [{card}]")


def _m2_stencil_time(label, A, x, card, times, rel=KERNEL_REL):
    """Kernel #3 on one extended block against its twin, timed beside its
    bound and cuSPARSE's CSR product of the same block."""
    y = spmv_stencil_cuda(A, x)
    err, scale = _max_err(y, spmv_stencil_ref(A, x))
    _require(err <= rel * scale, f"{label}: max err {err:.3e} against the twin")
    k_ms = time_ms(lambda: spmv_stencil_cuda(A, x), 50)
    p_ms = time_ms(lambda: spmv_stencil_ref(A, x), 3)
    csr = _stencil_csr(A)
    lib_ms = _library(label, lambda: csr @ x.reshape(-1), y.reshape(-1), card, 50)
    del csr
    item = A.data.dtype.itemsize
    nbytes = A.nnz * item + 2 * x.numel() * item
    bound = bound_ms(nbytes, 2 * A.nnz)
    times[label] = dict(shape=list(A.grid), legs=A.nlegs, dtype=TAGS[A.data.dtype], ms=k_ms,
                        plain_ms=p_ms, bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
                        max_abs_err=err)
    print(f"time spmv_stencil {label} {tuple(A.grid)} x {A.nlegs} legs {TAGS[A.data.dtype]}: max "
          f"err against the twin {err:.3e}; kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound "
          f"{bound[0]:.4f} ms by {bound[1]}, {bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms, "
          f"CSR {lib_ms:.4f} ms [{card}]")
    return err


def _m2_kernels(solve2, dev, card, errs, times):
    """Kernel #3 on the extended 2-D blocks the new paths run (256^3's
    (130, 130, 256) x 7 fp32, its local block against #3 on the global
    grid's; jump 512^2's (258, 258) fp64; convection 1024^2's (514, 514)
    beside its 1-D (258, 1024) slab) and #5 on a Poisson 1024^2 shard at
    k = M2_EIG_K, each against its twin and timed."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 61)
    op = solve2.operators[0]
    A = op.mats.parts[3]  # the shard at (1, 1)
    (H0, H1), (n0, n1) = op.halos, op.local[:2]
    lvl_grid = tuple(KIND_GRID_3D)
    x = torch.randn(lvl_grid, generator=gen, device=dev)
    xp = F.pad(x, (0, 0, H1, H1, H0, H0))
    x_ext = xp[n0:2 * n0 + 2 * H0, n1:2 * n1 + 2 * H1].contiguous()
    legs_g = Shards([op._narrowed(m.data, range(2)) for m in op.mats.parts], op.mesh)
    A_glob = StencilMatrix(legs_g.gather_grid(3), op.shifts, lvl_grid)
    y_glob = spmv_stencil_cuda(A_glob, x)[n0:, n1:]
    mid = spmv_stencil_cuda(A, x_ext)[H0:H0 + n0, H1:H1 + n1]
    _require(torch.equal(mid, y_glob), "2-D block #3: local block differs from the global rows")
    del A_glob, y_glob, legs_g, xp
    err = _m2_stencil_time("one (2, 2) block of Poisson 256^3", A, x_ext, card, times)
    errs["spmv_stencil"] = max(errs["spmv_stencil"], err)
    for label, s, g, dt, halo, rel in (
            ("one (2, 2) block of jump 512^2", generators.diffusion_system(M2_REF_GRID, kind="jump"),
             M2_REF_GRID, torch.float64, (1, 1), KERNEL_REL64),
            ("one (2, 2) block of convection 1024^2",
             generators.convection_diffusion_system(SNS_GRID, eps=NONSYM_EPS), SNS_GRID,
             torch.float32, (1, 1), KERNEL_REL),
            ("one 4-shard slab of convection 1024^2",
             generators.convection_diffusion_system(SNS_GRID, eps=NONSYM_EPS), SNS_GRID,
             torch.float32, 1, KERNEL_REL)):
        st = dia_to_stencil(s.A, g)
        legs = torch.from_numpy(st.data).to(dev, dt)
        # the (1, 1) block of a (2, 2) mesh, or the second of four slabs
        blk = legs[:, g[0] // 4:g[0] // 2] if halo == 1 else legs[:, g[0] // 2:, g[1] // 2:]
        ext = extend_grid_rows(blk, halo)
        Ab = StencilMatrix(ext, st.shifts, tuple(ext.shape[1:]))
        xb = torch.randn(Ab.grid, generator=gen, device=dev, dtype=dt)
        err = _m2_stencil_time(label, Ab, xb, card, times, rel)
        if dt == torch.float32:
            errs["spmv_stencil"] = max(errs["spmv_stencil"], err)
        del legs, blk, ext, Ab, xb
    # #5 on one shard of Poisson 1024^2 at k = M2_EIG_K: LOBPCG's A pass
    s = generators.poisson_system(M2_EIG_GRID)
    n_local = s.n // M2_SHARDS
    hb = s.A.bandwidth
    data = torch.from_numpy(s.A.data[:, n_local:2 * n_local]).to(dev, torch.float32)
    ext = extend_rows(data, hb)
    L = ext.shape[1]
    A5 = DiaMatrix(ext, tuple(s.A.offsets), (L, L))
    k = M2_EIG_K
    X = torch.randn((k, L), generator=gen, device=dev)
    Y = spmm_dia_cuda(A5, X)
    err, scale = _max_err(Y, spmm_dia_ref(A5, X))
    _require(err <= KERNEL_REL * scale, f"eig shard #5: max err {err:.3e} against the twin")
    for j in range(k):
        _require(torch.equal(Y[j], spmv_dia_cuda(A5, X[j].contiguous())),
                 f"eig shard #5: column {j} differs from kernel #4's product")
    errs["spmm_dia"] = max(errs["spmm_dia"], err)
    k_ms = time_ms(lambda: spmm_dia_cuda(A5, X), 200)
    p_ms = time_ms(lambda: spmm_dia_ref(A5, X), 5)
    csr = dia_csr(A5)
    lib_ms = _library(f"spmm_dia Poisson 1024^2 shard k={k}", lambda: (csr @ X.T).T, Y, card, 200)
    nbytes = spmm_bytes(A5, k)
    bound = bound_ms(nbytes, 2 * dia_nnz(A5) * k)
    times["eig shard"] = dict(rows=L, diagonals=A5.ndiags, k=k, ms=k_ms, plain_ms=p_ms,
                              bound_ms=bound[0], bound_by=bound[1], library_ms=lib_ms,
                              max_abs_err=err)
    print(f"time spmm_dia on one of {M2_SHARDS} shards' extended DIA of Poisson 1024^2 ({L} rows, "
          f"{A5.ndiags} diagonals) k={k} fp32: max err against the twin {err:.3e}, every column "
          f"#4's bit for bit; kernel {k_ms:.4f} ms ({nbytes / 1e6:.1f} MB; bound {bound[0]:.4f} ms "
          f"by {bound[1]}, {bound[0] / k_ms:.1%} of it), twin {p_ms:.4f} ms, CSR {lib_ms:.4f} ms "
          f"[{card}]")


def _mesh_eigs_and_blocks(poisson3, dev, card, count, errs, times):
    """The mesh eigensolvers (LOBPCG through ``api.eigs(mesh=)``,
    ``gspmd_arnoldi_eigs``) on four shards of the card, then the 2-D block
    partitions on a (2, 2) mesh of it beside the 1-D four-shard runs
    (``gspmd_mgcg`` 256^3, ``mg_bicgstab`` 1024^2, ``gspmd_refined_solve``
    512^2 jump, the probed build 256^3), then the kernels at the new
    shapes; each step's seconds."""
    steps = (("mesh LOBPCG", lambda: _m2_lobpcg(dev, card, count)),
             ("mesh Arnoldi", lambda: _m2_arnoldi(dev, card, count)),
             ("2-D MGCG", lambda: _m2_mgcg(poisson3, dev, card, count)),
             ("2-D mg_bicgstab", lambda: _m2_mg_bicgstab(dev, card, count)),
             ("2-D refined", lambda: _m2_refined(dev, card, count)),
             ("2-D probed build", lambda: _m2_probed(poisson3, dev, card, count)))
    out = {}
    for name, fn in steps:
        t0 = time.perf_counter()
        out[name] = fn()
        print(f"  {name}: {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _m2_kernels(out["2-D MGCG"], dev, card, errs, times)
    print(f"  kernels at the new shapes: {time.perf_counter() - t0:.1f} s")


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
                        ("dia", "spmm_dia_kernel"), ("dia", "dia_kernel_split"),
                        ("dia", "dia_batched_kernel"),
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

    # the 256^3 Galerkin hierarchy's host setup (115-137 s, most of it
    # scipy's sparse products) runs on a host thread beside the phases
    # before its first use (the rest of the multigrid build)
    s3g = _kind_system("poisson", KIND_GRID_3D)
    galerkin3 = (s3g, _hierarchy_on_thread(f"Galerkin Poisson {KIND_GRID_3D}", s3g, KIND_GRID_3D))

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
    # operators, then the 255^3 jump fine level and a 127^3 27-leg level
    t0 = time.perf_counter()
    sysj = generators.diffusion_system(VAR_GRID, kind="jump", contrast=VAR_CONTRAST, seed=SEED)
    A3j = dia_to_stencil(sysj.A, VAR_GRID).device_put(torch.float32, dev)
    w27 = _level_on_card((127, 127, 127), SHIFTS27, dev, SEED + 44)
    print(f"jump {VAR_GRID}: system and fine level in {time.perf_counter() - t0:.3f} s (no "
          f"hierarchy: the jump MGCG paths run at {JUMP_MG_GRID})")
    cases = []
    for label, g in VAR_CHECK_GRIDS:
        A_h = generators.diffusion_system(g, kind="jump", contrast=VAR_CONTRAST, seed=SEED).A
        cases.append((label, dia_to_stencil(A_h, g).device_put(torch.float32, dev)))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for label, shifts, g in VAR_HAND:
        legs = torch.rand((len(shifts),) + g, generator=gen, device=dev) * 2 - 1
        cases.append((f"hand-made {label}", StencilMatrix(legs, shifts, g)))
    cases += [("3-D 255^3 7 legs (jump)", A3j), ("127^3 27 legs (built on the card)", w27)]
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
    sysjm, hj = _var_hierarchy("jump", dev, JUMP_MG_GRID)
    var_mgcg, single_jump, walls["MGCG jump warm solve"] = _var_mgcg(sysjm, hj, dev, card)
    count(f"MGCG jump {JUMP_MG_GRID}", {"spmv_stencil": var_mgcg})
    syss, hs = _var_hierarchy("smooth", dev, SMOOTH_GRID)
    var_refine, single_smooth, _ = _var_refine_routes(syss, hs, dev, card)
    count("refined smooth 127^3 bf16 legs, host + device residual", {"spmv_stencil": var_refine})

    # -- the multi-RHS grid path, counted: the jump MGCG (reusing its
    # hierarchy), the 63^3 facade, the 127^3 smooth refined solve ------------
    multi_counts, walls["multi-RHS MGCG jump k=4"] = _multi_mgcg(sysjm, hj, single_jump, dev, card)
    count(f"multi-RHS MGCG jump {JUMP_MG_GRID} k={MULTI_K}", multi_counts)
    count(f"api.solve(B, mgcg) {FACADE_GRID} k={MULTI_K}", _facade_multi_mgcg(dev, card))
    count(f"refined_solve_multi smooth 127^3 k={REFINE_MULTI_K}",
          _refine_multi(syss, hs, single_smooth, dev, card))

    # -- kernel #6's path, counted: the experiment at its default shape ------
    acc_launches, acc_recs = _acc_experiment(sysj, dev)
    count("kernel #6 experiment", {"spmm_dia_acc": acc_launches})

    # -- the rest of the multigrid build, counted: hybrid, semicoarsening and
    # aggregation transfers (the wide kernel #3 checked first), DIA levels,
    # rbgs, W-cycle and fmg -------------------------------------------------
    t0 = time.perf_counter()
    wide_cases, galerkin2, poisson3 = _multigrid_kinds(galerkin3, dev, card, errs, count)
    del galerkin3, s3g
    print(f"phase: the rest of the multigrid build in {time.perf_counter() - t0:.1f} s")

    # -- the formats slice, counted: kernels #4 and #5 past 256 diagonals and
    # the DIA-layout MGCG over them; the reference's CSR and ELL storage;
    # Matrix Market ingestion ------------------------------------------------
    t0 = time.perf_counter()
    many_cases, many_splits = _dia_layout_mgcg(wide_cases, dev, card, errs, count)
    print(f"phase: past 256 diagonals and the {DIA_MGCG_GRID} DIA-layout MGCG in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    flagship_csr, handmade_csr, witness = _reference_storage(fsys, dev, card, count)
    print(f"phase: the reference's CSR and ELL storage in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    loaded = _ingestion(dev, card, count)
    print(f"phase: Matrix Market ingestion in {time.perf_counter() - t0:.1f} s")

    # -- the preconditioners, counted: AMG on the two .mtx files (cube
    # levels on #1/#3, greedy CSR levels), jump 127^3 as CSR (#3), the
    # flagship's Jacobi, block-Jacobi, Chebyshev and AMG routes (#4, #5);
    # card against CPU; the spectrum tools --------------------------------
    t0 = time.perf_counter()
    nat = _preconditioners(loaded, fsys, dev, card, count)
    del loaded
    print(f"phase: preconditioners in {time.perf_counter() - t0:.1f} s")

    # -- the drivers, counted: cg_solve against one CUDA graph per masked
    # chunk on four paths, checkpoint and resume, the traced driver, a
    # saved and loaded hierarchy, the reference_workloads twin ------------
    t0 = time.perf_counter()
    _drivers(_driver_paths(h3, b3, sysjm, hj, galerkin2, fsys, dev), syss, hs, dev, card, count)
    del syss, hs
    print(f"phase: drivers in {time.perf_counter() - t0:.1f} s")

    # -- the nonsymmetric and indefinite Krylov family, counted: convection-
    # diffusion 1023^2 (mg_bicgstab, jacobi_gmres, mg_fgmres, bicgstab), IDR
    # through auto, amg_bicgstab on a CSR, the flagship's nonsymmetric twin
    # (#4, #5, refined), Helmholtz through auto; card against CPU ---------
    t0 = time.perf_counter()
    _nonsymmetric(dev, card, count)
    print(f"phase: nonsymmetric in {time.perf_counter() - t0:.1f} s")

    # -- least squares, s-step, deflation, adjoints, counted: A^T on #4 and
    # CGNR / LSMR on the twin, the rectangular regression (cuSPARSE), CA-CG
    # on the flagship and Poisson 1023^2, def-CG on the outlier system and
    # its sequence, refined with deflation, the implicit adjoints, the
    # precision helpers; card against CPU -----------------------------------
    t0 = time.perf_counter()
    transposed = _least_squares(fsys, dev, card, count)
    print(f"phase: least squares, s-step, deflation, adjoints in {time.perf_counter() - t0:.1f} s")

    # -- the eigensolvers, counted: LOBPCG through api.eigs on Poisson
    # 511^2 (#5, the V-cycle's kernels) in fp32 and fp64, generalized on
    # 255^2 (#5 for A and B), Arnoldi at the JAX package's 511^2 convection
    # workload (#4), shift-invert (inner IDR on #4, the residual block on
    # #5); card against CPU; #5 at LOBPCG's 3k = 24 -------------------------
    t0 = time.perf_counter()
    _eigensolvers(dev, card, count)
    print(f"phase: eigensolvers in {time.perf_counter() - t0:.1f} s")

    # -- the host kit and the batched solves, counted: csrkit's conversions
    # against numpy's and api.solve(method="native"); batched #4 against its
    # twin and the single kernel; the batched CG sweep on the flagship (#4
    # batched, fused); vmap(grad) through both implicit solves ------------
    t0 = time.perf_counter()
    batched_times = {}
    _native_and_batched((("HandmadeCL", handmade_csr), ("flagship", flagship_csr)), fsys, dev,
                        card, errs, batched_times, count)
    print(f"phase: native and batched in {time.perf_counter() - t0:.1f} s")

    # -- the row-block-sharded CG, counted: the flagship assembled block by
    # block on 4 shards of the card, sharded_cg_solve by cg, cg1, pipelined
    # and cacg on 4 shards and 1 (#4 once a shard per product), the warm
    # times, api.solve(mesh=), sharded def-CG, the CSR/ELL solver ---------
    t0 = time.perf_counter()
    cg64 = _parallel((("HandmadeCL", handmade_csr), ("flagship", flagship_csr)), fsys, dev, card,
                     count, witness)
    del handmade_csr
    print(f"phase: parallel in {time.perf_counter() - t0:.1f} s")

    # -- the multi-process mesh, counted: one NCCL rank in this process on
    # the flagship's 4 shards (the parallel phase's fp64 CG bit for bit),
    # then the launcher's two Gloo ranks on the card: viennacl_large by
    # sharded CG (#4 a shard) and rung-5 Poisson 255^3 by probed MGCG (#3 a
    # shard) against a one-process 4-shard run here -------------------------
    t0 = time.perf_counter()
    _multi_process(cg64, dev, card, count)
    del cg64
    print(f"phase: multi-process in {time.perf_counter() - t0:.1f} s")

    # -- the sharded multigrid, counted: shard_mgcg_solve on 256^3 (cg,
    # cg1, pipelined on 4 shards, cg on 1) and 1024^2 (Chebyshev, rbgs),
    # the multi-RHS MGCG, the flagship's block solves (#5 a shard), the
    # facade's mesh routes (the replicated 1023^2, refined on #4 fp64 a
    # shard), #3 and #5 at the shards' shapes, warm times ----------------
    t0 = time.perf_counter()
    shard_times = {}
    _sharded_multigrid(poisson3, galerkin2, fsys, dev, card, count, errs, shard_times)
    del galerkin2
    print(f"phase: sharded multigrid in {time.perf_counter() - t0:.1f} s")

    # -- the eigensolvers over a mesh and the 2-D block partitions, counted:
    # api.eigs(mesh=) by LOBPCG on Poisson 1024^2 (#5 a shard, the sharded
    # V-cycle's #3), gspmd_arnoldi_eigs on convection 512^2 (#4 a shard);
    # on a (2, 2) mesh beside the 1-D 4 shards: gspmd_mgcg 256^3,
    # mg_bicgstab 1024^2, gspmd_refined_solve 512^2 jump (#3 fp64 a block),
    # the probed build 256^3; #3 and #5 at the new shapes ----------------
    t0 = time.perf_counter()
    m2_times = {}
    _mesh_eigs_and_blocks(poisson3, dev, card, count, errs, m2_times)
    del poisson3
    print(f"phase: mesh eigensolvers and 2-D blocks in {time.perf_counter() - t0:.1f} s")

    # -- the sharded nonsymmetric family and the distributed AMG, counted:
    # convection 1024^2 by bicgstab, jacobi_gmres, idr, mg_bicgstab and
    # mg_gmres (the sharded V-cycle, #3 a shard), MINRES on Helmholtz
    # 256^2, LSMR and the Chebyshev block loop on the padded flagship (#4 a
    # shard), amg_cg and amg_bicgstab on the 127^3 natural hierarchy; each
    # on 4 shards, on 1 and on one device ---------------------------------
    t0 = time.perf_counter()
    _sharded_nonsym(nat, fsys, dev, card, count)
    del nat
    print(f"phase: sharded nonsymmetric in {time.perf_counter() - t0:.1f} s")

    # -- rung 5, counted: Poisson 511^3 assembled slab by slab onto 4 shards
    # of the card, its hierarchy probed on the shards (#3 a shard a probe),
    # MGCG; #3 on one rung-5 shard's slab; the probed build against the
    # host build at 127^3; the rediscretized convection 256^3 by mg
    # BiCGStab (#3 a shard) ---------------------------------------------
    t0 = time.perf_counter()
    r5_times = {}
    _rung5(dev, card, count, errs, r5_times)
    print(f"phase: rung 5 in {time.perf_counter() - t0:.1f} s")

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
    _var_times(A3j, w27, dev, card, times)
    lib, bounds = _library_and_bounds(ops, fsys, sysj, A3j, dev, card, times)
    times.update(batched_times)
    for name in ("spmv_dia_batched", "spmv_dot_dia_batched"):
        _, _, lib[name], bounds[name] = times[(name, BATCH_MAIN, "fp32", BATCH_SWEEP_K)]
    _acc_times(sysj, acc_recs, dev, card, times, lib, bounds)
    _wide_times(wide_cases, dev, card, times, lib, bounds)
    t0 = time.perf_counter()
    many_times = _many_diag_times(many_cases, dev, card)
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
                  "spmv_stencil_wide": ("spmv_stencil_wide", "128^3 81 legs", "fp32"),
                  "spmv_dia_batched": ("spmv_dia_batched", BATCH_MAIN, "fp32", BATCH_SWEEP_K),
                  "spmv_dot_dia_batched": ("spmv_dot_dia_batched", BATCH_MAIN, "fp32",
                                           BATCH_SWEEP_K)}
    record = [
        dict(name=name, **meta, launches=launches[name], launches_by_path=by_path[name],
             max_abs_err=errs[name], ms=times[main_shape[name]][0],
             plain_ms=times[main_shape[name]][1], bound_ms=bounds[name][0],
             bound_by=bounds[name][1], library_ms=lib[name])
        for name, meta in KERNELS.items()
    ]
    for r in record:
        _require(r["launches"] > 0, f"{r['name']}: no launch on its path")
        if r["name"] in many_times:  # past 256 diagonals: the split's S and graph times
            r.update(split_by_shape=many_splits, past_256_diagonals=many_times[r["name"]])
        if r["name"] == "spmv_dia":  # the nonsymmetric twin's transpose, fp32
            r["transposed_dia"] = transposed
        if r["name"] == "spmv_stencil":  # one shard's extended 256^3 and 511^3 slabs
            r["shard_slab"] = shard_times["shard slab"]
            r["rung5_slab"] = r5_times["rung5 slab"]
        if r["name"] == "spmv_stencil":  # the extended 2-D blocks (and a 1-D slab beside one)
            r["block_2d"] = {k: v for k, v in m2_times.items() if k != "eig shard"}
        if r["name"] == "spmm_dia":  # one shard's extended flagship DIA, k = 4
            r["shard_dia"] = shard_times["shard dia"]
            r["eig_shard"] = m2_times["eig shard"]  # LOBPCG's A pass, Poisson 1024^2, k = 8
    print(f"run: {time.perf_counter() - t_run:.1f} s after the build")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
