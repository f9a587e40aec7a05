"""Row-block-sharded solves over a mesh of devices (a mesh may repeat a
device): the port of ``conjugategradient_tpu/parallel``'s mesh, halo,
sharded CG (DIA and CSR/ELL), the sharded nonsymmetric family
(``shard_nonsym``), the sharded multigrid (``shard_mgcg``, ``shard_multi``),
the distributed AMG (``shard_amg``), the GSPMD carriers as explicit
collectives (``gspmd``), the single-process half of ``multihost`` and
rung 5 (``rung5``: systems assembled slab by slab onto the shards, solved
over the hierarchies ``precond.distributed`` builds on them)."""

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
from conjugategradient_tpu_torch.parallel.shard_mgcg import (  # noqa: F401
    make_shard_mgcg,
    shard_mgcg_solve,
)
from conjugategradient_tpu_torch.parallel.shard_multi import (  # noqa: F401
    make_shard_multi_mgcg,
    shard_multi_mgcg_solve,
)
from conjugategradient_tpu_torch.parallel.shard_amg import (  # noqa: F401
    build_sharded_amg,
    sharded_amg_solve,
)
from conjugategradient_tpu_torch.parallel.gspmd import (  # noqa: F401
    gspmd_mgcg_solve,
    make_gspmd_mgcg,
    shard_system,
)
# the port's own: the sharded nonsymmetric family and the multigrid-
# preconditioned nonsymmetric carrier
from conjugategradient_tpu_torch.parallel.shard_nonsym import (  # noqa: F401, E402
    sharded_lsmr_solve,
    sharded_nonsym_solve,
)
from conjugategradient_tpu_torch.parallel.gspmd import gspmd_mg_nonsym_solve  # noqa: F401, E402
# the port's own: the mesh and the row-sharded value its solvers take
from conjugategradient_tpu_torch.parallel.mesh import Mesh, Shards  # noqa: F401, E402
