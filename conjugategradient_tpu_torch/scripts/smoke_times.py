"""``chip_smoke.py`` with its functions timed: where the smoke's time goes,
to choose what to cut before a phase is added.

    python -m conjugategradient_tpu_torch.scripts.smoke_times [--min-s 1.5]

Run on the card from the root of a checkout: it imports ``chip_smoke``
from the working directory, wraps each of its module-level functions
(``main`` aside) so that a call of ``--min-s`` seconds or more prints
``T <name> <seconds>`` as it returns (a nested call before its caller),
and runs ``chip_smoke.main()``: the smoke's own output and exit code, with
those lines among the output.
"""

from __future__ import annotations

import argparse
import functools
import inspect
import os
import sys
import time


def _timed(name: str, fn, min_s: float):
    @functools.wraps(fn)
    def call(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            dt = time.perf_counter() - t0
            if dt >= min_s:
                print(f"T {name} {dt:.1f}", flush=True)

    return call


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--min-s", type=float, default=1.5, help="the shortest call printed, seconds")
    args = p.parse_args(argv)
    sys.path.insert(0, os.getcwd())
    import chip_smoke

    for name, fn in list(vars(chip_smoke).items()):
        if inspect.isfunction(fn) and fn.__module__ == "chip_smoke" and name != "main":
            setattr(chip_smoke, name, _timed(name, fn, args.min_s))
    return chip_smoke.main()


if __name__ == "__main__":
    sys.exit(main())
