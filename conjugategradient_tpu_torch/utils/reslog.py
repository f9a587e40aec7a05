"""Structured residual logging.

``cg_solve_traced`` returns a dense residual history (a device tensor, no
host read inside the solve); this module turns it into records carrying the
norm conventions explicitly, serialisable to JSONL and CSV.  The port of
``conjugategradient_tpu/utils/reslog.py``.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Iterable, List, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ResidualRecord:
    iteration: int
    l2: float
    rel_l2: float
    linf: Optional[float] = None  # only when the linf history was requested

    def to_json(self) -> str:
        d = {"iteration": self.iteration, "l2": self.l2, "rel_l2": self.rel_l2}
        if self.linf is not None:
            d["linf"] = self.linf
        return json.dumps(d)


def _host(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)).astype(np.float64)


def records_from_history(
    history, iterations: Optional[int] = None, linf_history=None, r0: Optional[float] = None
) -> List[ResidualRecord]:
    """Convert a ``cg_solve_traced`` L2 residual history (a tensor on any
    device, or an array) into records.

    ``history[k]`` is ‖r‖₂ after iteration k+1; entries after convergence
    are frozen (flat): pass ``iterations`` to trim to the active prefix.

    ``r0`` is the *initial* residual ‖b − A x₀‖₂, the denominator of the
    solver's ``rel_l2`` convention.  Without it the records normalise by
    ``history[0]``, the residual *after* the first iteration, so the first
    record's rel_l2 is exactly 1.0 and every later one disagrees with the
    solver's rel_l2: pass the true r0 for convention-exact logs.
    """
    h = _host(history)
    n = int(iterations) if iterations is not None else len(h)
    r0 = float(r0) if r0 is not None else (h[0] if len(h) else 1.0)
    linf = None if linf_history is None else _host(linf_history)
    out = []
    for k in range(min(n, len(h))):
        out.append(
            ResidualRecord(
                iteration=k + 1,
                l2=float(h[k]),
                rel_l2=float(h[k] / r0) if r0 > 0 else 0.0,
                linf=None if linf is None else float(linf[k]),
            )
        )
    return out


def write_jsonl(path: str, records: Iterable[ResidualRecord]) -> None:
    with open(path, "w") as f:
        for r in records:
            f.write(r.to_json() + "\n")


def write_csv(path: str, records: Iterable[ResidualRecord]) -> None:
    records = list(records)
    has_linf = any(r.linf is not None for r in records)
    with open(path, "w") as f:
        f.write("iteration,l2,rel_l2" + (",linf" if has_linf else "") + "\n")
        for r in records:
            row = f"{r.iteration},{r.l2!r},{r.rel_l2!r}"
            if has_linf:
                row += f",{'' if r.linf is None else repr(r.linf)}"
            f.write(row + "\n")


def convergence_rate(records: List[ResidualRecord]) -> float:
    """Geometric-mean per-iteration residual reduction factor (for CG it
    tracks (sqrt(kappa)-1)/(sqrt(kappa)+1))."""
    if len(records) < 2:
        return float("nan")
    first, last = records[0].l2, records[-1].l2
    if first <= 0 or last <= 0:
        return float("nan")
    return float((last / first) ** (1.0 / (len(records) - 1)))
