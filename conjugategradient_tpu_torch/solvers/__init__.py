"""Convergence policy, CG (while-loop, traced and chunked drivers), multi-RHS
CG and BiCGStab, mixed-precision refinement, the eigenvalue diagnostics,
the nonsymmetric and indefinite Krylov family (``bicgstab``, ``gmres``,
``minres``, ``idr``, ``cheby``), least squares (``cgnr``, ``lsmr``), s-step
CG (``cacg``), deflated CG (``deflation``) and the differentiable solves
(``diff``)."""

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_chunked,
    cg_solve_traced,
)
from conjugategradient_tpu_torch.solvers import eigen  # noqa: F401
from conjugategradient_tpu_torch.solvers.deflation import (  # noqa: F401
    Deflation,
    deflated_cg_solve,
    make_deflation,
)
from conjugategradient_tpu_torch.solvers.cgnr import cgnr_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.lsmr import lsmr_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.cacg import cacg_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.diff import (  # noqa: F401
    bicgstab_solve_implicit,
    cg_solve_implicit,
)
