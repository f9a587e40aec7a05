"""Convergence policy, CG (while-loop, traced and chunked drivers), multi-RHS
CG and mixed-precision refinement."""

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_chunked,
    cg_solve_traced,
)
