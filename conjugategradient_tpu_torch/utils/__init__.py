"""Aux subsystems: phase timing, structured residual logs, checkpoint/resume
and the spy plot; the port of ``conjugategradient_tpu/utils``."""

from conjugategradient_tpu_torch.utils import checkpoint, reslog, spy, timers  # noqa: F401
from conjugategradient_tpu_torch.utils.checkpoint import (  # noqa: F401
    CGState,
    load_pytree,
    load_state,
    save_pytree,
    save_state,
)
from conjugategradient_tpu_torch.utils.reslog import ResidualRecord, records_from_history  # noqa: F401
from conjugategradient_tpu_torch.utils.spy import spy as spy_plot  # noqa: F401
from conjugategradient_tpu_torch.utils.timers import PhaseTimer, profiler_trace  # noqa: F401
