"""Convergence policy, CG (while-loop, traced and chunked drivers), multi-RHS
CG and BiCGStab, mixed-precision refinement, the eigenvalue diagnostics and
eigensolvers (``eigen``, ``lobpcg``, ``arnoldi``), the nonsymmetric and
indefinite Krylov family (``bicgstab``, ``gmres``, ``minres``, ``idr``,
``cheby``), least squares (``cgnr``, ``lsmr``), s-step CG (``cacg``),
deflated CG (``deflation``) and the differentiable solves (``diff``).

The names below are the JAX package's ``solvers`` names, in its order."""

from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, Norm  # noqa: F401
from conjugategradient_tpu_torch.solvers.cg import (  # noqa: F401
    CGResult,
    cg_solve,
    cg_solve_chunked,
    cg_solve_traced,
)
from conjugategradient_tpu_torch.solvers.deflation import (  # noqa: F401
    Deflation,
    deflated_cg_solve,
    make_deflation,
)
from conjugategradient_tpu_torch.solvers.bicgstab import (  # noqa: F401
    bicgstab_solve,
    bicgstab_solve_traced,
)
from conjugategradient_tpu_torch.solvers.cgnr import cgnr_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.idr import idr_solve, idr_solve_traced  # noqa: F401
from conjugategradient_tpu_torch.solvers.lsmr import lsmr_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.cacg import cacg_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.cheby import chebyshev_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.diff import (  # noqa: F401
    bicgstab_solve_implicit,
    cg_solve_implicit,
)
from conjugategradient_tpu_torch.solvers.minres import minres_solve  # noqa: F401
from conjugategradient_tpu_torch.solvers.gmres import (  # noqa: F401
    fgmres_solve,
    gmres_solve,
    gmres_solve_traced,
    inner_solve_preconditioner,
)
from conjugategradient_tpu_torch.solvers.arnoldi import EigsResult, arnoldi_eigs  # noqa: F401
from conjugategradient_tpu_torch.solvers.lobpcg import LobpcgResult, lobpcg  # noqa: F401
from conjugategradient_tpu_torch.solvers.multi import (  # noqa: F401
    MultiCGResult,
    bicgstab_solve_multi,
    cg_solve_multi,
)
from conjugategradient_tpu_torch.solvers.refine import (  # noqa: F401
    RefineMultiResult,
    RefineResult,
    refined_solve,
    refined_solve_multi,
)
from conjugategradient_tpu_torch.solvers import eigen  # noqa: F401
