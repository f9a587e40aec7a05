"""Named workloads: the reference's problem configurations and the config ladder."""

from conjugategradient_tpu_torch.models.workloads import (  # noqa: F401
    LADDER,
    WORKLOADS,
    Workload,
    build,
    get,
)
