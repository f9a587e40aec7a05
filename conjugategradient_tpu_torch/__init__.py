"""conjugategradient_tpu_torch — the PyTorch/CUDA port of conjugategradient_tpu.

The JAX package beside it is the reference; this package does the same work
in PyTorch on an NVIDIA H100, with every Pallas kernel of a ported path
rewritten by hand for Hopper (``csrc/``).  The layout mirrors the
reference's, so each counterpart is found by path:

- ``core``    — numpy host containers (DIA / stencil / const stencil), the
                Poisson generators and the fp64 oracle SpMV.
- ``ops``     — BLAS-1, compensated dots, the const-stencil SpMV and the
                fused Chebyshev smoother (CUDA kernels with plain twins).
- ``solvers`` — convergence policy and (preconditioned) CG.
- ``precond`` — smoothers, fw transfers and the geometric-multigrid
                V-cycle (MGCG).
- ``convert`` — carries a hierarchy across from the reference's fields.

This package imports ``torch``, numpy and scipy, never ``jax``.  See
ROADMAP.md for what is ported and what is still to come.
"""

__version__ = "0.1.0"

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import CGResult, cg_solve  # noqa: F401
