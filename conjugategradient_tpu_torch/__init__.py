"""conjugategradient_tpu_torch — the PyTorch/CUDA port of conjugategradient_tpu.

The JAX package beside it is the reference; this package does the same work
in PyTorch on an NVIDIA H100, with every Pallas kernel of a ported path
rewritten by hand for Hopper (``csrc/``).  The layout mirrors the
reference's, so each counterpart is found by path:

- ``core``    — numpy host containers (DIA, stencil, const stencil, ELL,
                CSR, COO, BSR, dense) and their conversions, the row-block
                partition math, the DOK builder, Matrix Market and scipy ingestion, the banded,
                tridiagonal, Poisson, variable-coefficient and anisotropic
                diffusion, convection-diffusion, Helmholtz, nonsymmetric
                banded and outlier generators and the fp64 oracle (SpMV of every
                format, CG, the dense direct solve).
- ``ops``     — BLAS-1, compensated dots and sums, and the CUDA kernels with their
                plain twins: the const-stencil SpMV, the fused Chebyshev
                smoother, the variable-coefficient stencil SpMV (tuned at
                halo 1, wide at halo 2; and its per-column SpMM), the DIA SpMV (and its fused p·Ap,
                chained past 256 diagonals; CSR and ELL reach it by a
                relayout), the DIA SpMM and its single-call accumulating
                form; the plain CSR, ELL, COO, BSR and dense products.
- ``solvers`` — convergence policy, (preconditioned) CG with its traced
                and chunked drivers (checkpoint/resume; one CUDA graph
                per chunk on the card), multi-RHS CG and BiCGStab and
                the multigrid preconditioner of a block, mixed-precision
                iterative refinement (the flagship path; CG or BiCGStab
                inside), the eigenvalue diagnostics (Jacobi rotations,
                power iteration, Lanczos and Gershgorin bounds, the
                spectrum of a CG run), the eigensolvers (LOBPCG and
                Krylov-Schur Arnoldi with shift-invert), and the nonsymmetric and indefinite
                Krylov family: BiCGStab, GMRES and FGMRES, MINRES, IDR(s),
                the Chebyshev iteration; least squares (CGNR, LSMR),
                s-step CG, deflated CG and the implicit-adjoint
                (differentiable) solves, batched CG and BiCGStab over k
                systems of one sparsity (``torch.func.vmap`` of the implicit
                solves).
- ``precond`` — smoothers (Jacobi, Chebyshev, red-black Gauss-Seidel), the
                point- and block-Jacobi and Chebyshev-polynomial
                preconditioners, the fw, hybrid, semicoarsening and
                aggregation transfers, the multigrid hierarchy (Galerkin or
                rediscretized), V- and W-cycles and fmg (MGCG), and
                smoothed-aggregation AMG for matrices with no grid (its
                greedy aggregation in the host kit, ``native``).
- ``models``  — the named workloads of the reference's drivers.
- ``api``     — ``solve(A, b, method=...)`` for the ported methods and
                ``eigs(A, k, which=...)``, the eigensolver facade (LOBPCG,
                Krylov-Schur Arnoldi, shift-invert).
- ``convert`` — carries a hierarchy (geometric or AMG) or any container
                across from the reference's fields.
- ``native``  — the host C++ kit (``csrc/csrkit.cpp``, OpenMP): COO/CSR/
                DIA/ELL conversions, halo ranges, the banded generator, a
                CSR CG (``method="native"``) and the greedy aggregation,
                each with its numpy fallback where no compiler exists.
- ``parallel`` — row-block-sharded CG over a mesh of devices (a device
                may repeat: several shards on one card): the mesh, its
                collectives, the halo products on kernel #4, sharded CG
                (DIA; CSR/ELL with exact halos) and per-block assembly.
- ``utils``   — phase timers, the profiler trace scope, residual logs,
                checkpoint/resume and tree persistence, the spy plot.
- ``scripts`` — runnable measurements on the card (the kernel #6
                experiment), the ``reference_workloads`` twin and the
                ``inverse_demo`` coefficient recovery.

This package imports ``torch``, numpy and scipy, never ``jax``.  See
ROADMAP.md for what is ported and what is still to come.  The root names
are the JAX package's and the port's own additions after them.
"""

__version__ = "0.1.0"

from conjugategradient_tpu_torch.core.formats import (  # noqa: F401
    BsrMatrix,
    CooMatrix,
    CsrMatrix,
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
)
from conjugategradient_tpu_torch.core.builder import DokBuilder  # noqa: F401

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_chunked,
    cg_solve_traced,
)
from conjugategradient_tpu_torch.api import eigs, solve  # noqa: F401
from conjugategradient_tpu_torch import native  # noqa: F401
from conjugategradient_tpu_torch.precond.amg import (  # noqa: F401
    AmgHierarchy,
    amg_cg_solve,
    build_amg_hierarchy,
)
from conjugategradient_tpu_torch.solvers import (  # noqa: F401
    Deflation,
    bicgstab_solve_implicit,
    cacg_solve,
    cg_solve_implicit,
    cgnr_solve,
    deflated_cg_solve,
    lsmr_solve,
    make_deflation,
)
