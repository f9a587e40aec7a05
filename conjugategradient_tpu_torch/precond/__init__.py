"""Preconditioners: point and block Jacobi, Chebyshev smoothing and
polynomials, geometric multigrid and algebraic (smoothed-aggregation)
multigrid."""

from conjugategradient_tpu_torch.precond import smoothers, transfer  # noqa: F401
from conjugategradient_tpu_torch.precond.amg import (  # noqa: F401
    AmgHierarchy,
    AmgLevel,
    amg_cg_solve,
    amg_preconditioner,
    amg_vcycle,
    build_amg_hierarchy,
)
from conjugategradient_tpu_torch.precond.multigrid import (  # noqa: F401
    MgHierarchy,
    MgLevel,
    as_preconditioner,
    build_hierarchy,
    fmg,
    galerkin_coarse,
    mgcg_solve,
    v_cycle,
)
from conjugategradient_tpu_torch.precond.block_jacobi import (  # noqa: F401
    block_jacobi_M_local,
    block_jacobi_aux,
    block_jacobi_blocks,
    block_jacobi_preconditioner,
)
from conjugategradient_tpu_torch.precond.smoothers import (  # noqa: F401
    chebyshev_preconditioner,
    chebyshev_preconditioner_for,
    chebyshev_smooth,
    jacobi_preconditioner,
    jacobi_smooth,
)
