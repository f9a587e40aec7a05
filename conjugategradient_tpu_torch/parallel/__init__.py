"""Row-block-sharded solves over a mesh of devices (a mesh may repeat a
device): the port of ``conjugategradient_tpu/parallel``'s mesh, halo,
sharded CG (DIA and CSR/ELL) and the single-process half of ``multihost``.
The mesh-sharded multigrid, AMG, nonsymmetric and GSPMD carriers are still
to port (ROADMAP queue 1: parallel)."""

from conjugategradient_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from conjugategradient_tpu_torch.parallel.halo import (  # noqa: F401
    exchange_halos,
    halo_exchange,
    ring_gather,
    spmv_dia_allgather,
    spmv_dia_local,
    spmv_dia_local_overlap,
)
from conjugategradient_tpu_torch.parallel.sharded_cg import (  # noqa: F401
    make_sharded_cg,
    sharded_cg_loop,
    sharded_cg_solve,
)
from conjugategradient_tpu_torch.parallel.sharded_general import (  # noqa: F401
    make_sharded_cg_general,
    sharded_cg_solve_general,
)
# the port's own: the mesh and the row-sharded value its solvers take
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards  # noqa: F401, E402
