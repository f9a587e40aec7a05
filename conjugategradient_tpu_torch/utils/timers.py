"""Phase timing that ends each phase on the device.

A host clock around an asynchronous CUDA launch measures the enqueue, so
every phase here ends by synchronising the device of its ``sync`` target's
tensors (the port's ``jax.block_until_ready``); the report keeps the JAX
package's format (per-phase ms, per-iteration microseconds).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import torch


@dataclasses.dataclass
class Phase:
    name: str
    seconds: float

    @property
    def ms(self) -> float:
        return self.seconds * 1e3


def _tensors(obj):
    """The tensors of ``obj``: a tensor, an object with tensor attributes
    (a ``CGResult``), or a list, tuple or dict of them."""
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _tensors(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _tensors(o)
    elif dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _tensors(getattr(obj, f.name))


def block_until_ready(obj) -> None:
    """Wait for the work behind every CUDA tensor of ``obj``: one
    synchronise per device they lie on (nothing for CPU tensors)."""
    for dev in {t.device for t in _tensors(obj) if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)


class PhaseTimer:
    """Accumulates named, device-synchronised phases.

    >>> t = PhaseTimer()
    >>> with t.phase("input"):
    ...     dev = torch.from_numpy(host_array).cuda()      # doctest: +SKIP
    >>> with t.phase("solve", sync=lambda: result):        # doctest: +SKIP
    ...     result = solve(dev)
    >>> print(t.report(iterations=result.iterations))       # doctest: +SKIP
    """

    def __init__(self) -> None:
        self.phases: List[Phase] = []

    @contextlib.contextmanager
    def phase(self, name: str, sync: Any = None):
        """Time a phase; if ``sync`` is given (tensors, or a structure of
        them), wait for its device at the end.  ``sync`` may also be a
        zero-argument callable evaluated at the phase's end that returns
        the value to wait on (for outputs created inside the block)."""
        t0 = time.perf_counter()
        holder: Dict[str, Any] = {}
        try:
            yield holder
        finally:
            target = holder.get("sync", sync)
            if callable(target) and not torch.is_tensor(target):
                target = target()
            if target is not None:
                block_until_ready(target)
            self.phases.append(Phase(name, time.perf_counter() - t0))

    def __getitem__(self, name: str) -> float:
        for p in reversed(self.phases):
            if p.name == name:
                return p.seconds
        raise KeyError(name)

    @property
    def total(self) -> float:
        return sum(p.seconds for p in self.phases)

    def report(self, iterations: Optional[int] = None) -> str:
        """The ViennaCL-driver style input/exec/output report, extended."""
        parts = [f"{p.name} {p.ms:9.2f} ms" for p in self.phases]
        line = " | ".join(parts) + f" | total {self.total*1e3:9.2f} ms"
        if iterations:
            solve_s = None
            for p in self.phases:
                if p.name in ("solve", "exec", "compute"):
                    solve_s = p.seconds
            per_it = (solve_s if solve_s is not None else self.total) / max(iterations, 1)
            line += f" | {iterations} it, {per_it*1e6:.1f} us/it"
        return line

    def as_dict(self) -> Dict[str, float]:
        return {p.name: p.seconds for p in self.phases}


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str]):
    """``torch.profiler`` trace scope (no-op when ``log_dir`` is None): the
    host and, where there is a card, the device activity of the block,
    written into ``log_dir`` as a Chrome trace (``trace.json``)."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
