"""conjugategradient_tpu_torch — the PyTorch/CUDA port of conjugategradient_tpu.

The JAX package beside it is the reference; this package does the same work
in PyTorch on an NVIDIA H100, with every Pallas kernel of a ported path
rewritten by hand for Hopper (``csrc/``).  The layout mirrors the
reference's, so each counterpart is found by path:

- ``core``    — numpy host containers (DIA / stencil / const stencil), the
                banded, tridiagonal and Poisson generators and the fp64
                oracle (SpMV and CG).
- ``ops``     — BLAS-1, compensated dots, and the CUDA kernels with their
                plain twins: the const-stencil SpMV, the fused Chebyshev
                smoother, the DIA SpMV (and its fused p·Ap) and the DIA SpMM.
- ``solvers`` — convergence policy, (preconditioned) CG, multi-RHS CG and
                mixed-precision iterative refinement (the flagship path).
- ``precond`` — smoothers, fw transfers and the geometric-multigrid
                V-cycle (MGCG).
- ``models``  — the named workloads of the reference's drivers.
- ``api``     — ``solve(A, b, method=...)`` for the ported methods.
- ``convert`` — carries a hierarchy or a DIA matrix across from the
                reference's fields.

This package imports ``torch``, numpy and scipy, never ``jax``.  See
ROADMAP.md for what is ported and what is still to come.
"""

__version__ = "0.1.0"

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve  # noqa: F401
