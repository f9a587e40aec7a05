"""Convergence policy, CG (while-loop, traced and chunked drivers), multi-RHS
CG and BiCGStab, mixed-precision refinement, the eigenvalue diagnostics,
and the nonsymmetric and indefinite Krylov family (``bicgstab``,
``gmres``, ``minres``, ``idr``, ``cheby``)."""

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_chunked,
    cg_solve_traced,
)
from conjugategradient_tpu_torch.solvers import eigen  # noqa: F401
