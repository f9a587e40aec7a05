"""Named benchmark workloads: the reference's exact problem configurations
plus the config ladder.

A copy of ``conjugategradient_tpu/models/workloads.py`` (the tests hold every
field equal): each ``Workload`` pins the generator, RHS/x0 recipes,
tolerance, norm convention and iteration policy of one reference driver, so
a solve of ``WORKLOADS["cublas_flagship"]`` reproduces
``Mgcg/cuBlas/Mgcg/MgcgMain.cs``.  Sizes are kept verbatim (207,402 rows for
the flagship); the reference workloads carry ``grid=None`` and run the
gridless DIA path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.generators import LinearSystem
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy


@dataclasses.dataclass(frozen=True)
class Workload:
    name: str
    description: str
    policy: ConvergencePolicy
    builder: str  # generator family
    n: int = 0
    band: int = 0
    grid: Optional[Tuple[int, ...]] = None
    b_kind: str = "cos10"
    x0_kind: str = "zeros"
    source: str = ""  # reference citation

    def build(self, dtype=None) -> LinearSystem:
        dt = dtype or np.float64
        if self.builder == "banded_sin":
            return generators.banded_sin_system(self.n, self.band, self.b_kind, self.x0_kind, dtype=dt)
        if self.builder == "tridiagonal":
            return generators.tridiagonal_system(self.n, dtype=dt)
        if self.builder == "poisson":
            return generators.poisson_system(self.grid, dtype=dt)
        raise ValueError(f"unknown builder {self.builder!r}")

    @property
    def size(self) -> int:
        return self.n if self.grid is None or self.n else int(np.prod(self.grid))

    def build_rows(self, lo: int, hi: int, dtype=None):
        """Per-row-block generation serves the multi-host path only."""
        raise NotImplementedError(
            "Workload.build_rows (row-block generation for the multi-host path) is not "
            "ported yet (ROADMAP queue 1 item 12: parallel)"
        )


WORKLOADS = {
    w.name: w
    for w in [
        # --- the reference's five drivers (BASELINE.md workload table) ---
        Workload(
            name="cublas_flagship",
            description="cuBlas CPU vs 1-GPU vs multi-GPU CG: N=207,402 band-160 |sin(i+j)|",
            policy=ConvergencePolicy(tol=1e-8, norm="l2", min_iteration=200),
            builder="banded_sin",
            n=207_402,
            band=160,
            b_kind="cos10",
            x0_kind="i/100",
            source="Mgcg/cuBlas/Mgcg/MgcgMain.cs:15-35,53-104",
        ),
        Workload(
            name="handmade_cl",
            description="HandmadeCL CPU vs 1-GPU CG: N=345,678 band-160, Linf norm",
            policy=ConvergencePolicy(tol=1e-4, norm="linf", min_iteration=50),
            builder="banded_sin",
            n=345_678,
            band=160,
            b_kind="cos10",
            x0_kind="i/100",
            source="Mgcg/HandmadeCL/MgcgCL/MgcgCLMain.cs:15-35",
        ),
        Workload(
            name="simple_cuda",
            description="Simple CUDA CG: N=65,536 tridiagonal (2,1), b=i^2/2",
            policy=ConvergencePolicy(tol=1e-8, norm="l2"),
            builder="tridiagonal",
            n=65_536,
            source="SimpleConjugateGradient.cu:130-134,163-196",
        ),
        Workload(
            name="viennacl_small",
            description="ViennaCL small: N=10 band-6, relative L2",
            policy=ConvergencePolicy(tol=1e-4, norm="rel_l2"),
            builder="banded_sin",
            n=10,
            band=6,
            b_kind="one_plus",
            source="Mgcg/ViennaCL/MgcgCL/MgcgCLMain.cs:14-30",
        ),
        Workload(
            name="viennacl_large",
            description="ViennaCL large: N=172,835 band-160, relative L2, 2 reps",
            policy=ConvergencePolicy(tol=1e-4, norm="rel_l2"),
            builder="banded_sin",
            n=172_835,
            band=160,
            b_kind="asin",
            source="Mgcg/ViennaCL/MgcgCL/MgcgCL.cs:14-30",
        ),
        Workload(
            name="r_prototype",
            description="R prototype: N=21 band-6 dense sanity check",
            policy=ConvergencePolicy(tol=1e-10, norm="l2"),
            builder="banded_sin",
            n=21,
            band=6,
            b_kind="one_plus",
            x0_kind="i/10",
            source="R/CG.R:1-24",
        ),
        # --- BASELINE.json config ladder ---
        Workload(
            name="ladder_dense_1k",
            description="ladder 1: dense-scale CG on 1k SPD system (CPU-runnable fp64)",
            policy=ConvergencePolicy(tol=1e-8, norm="l2"),
            builder="banded_sin",
            n=1023,
            band=8,
            grid=(1023,),
            source="BASELINE.json configs[0]",
        ),
        Workload(
            name="ladder_poisson2d_100k",
            description="ladder 2: plain CG on ~100k-row 2D Poisson, 1 chip",
            policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"),
            builder="poisson",
            grid=(319, 319),
            source="BASELINE.json configs[1]",
        ),
        Workload(
            name="ladder_mgcg2d_1m",
            description="ladder 3: MGCG V-cycle Jacobi on ~1M-row 2D Poisson, 1 chip",
            policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"),
            builder="poisson",
            grid=(1023, 1023),
            source="BASELINE.json configs[2]",
        ),
        Workload(
            name="ladder_mgcg3d_10m",
            description="ladder 4: MGCG 4+ level Chebyshev on ~10M-row-scale 3D Poisson",
            policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"),
            builder="poisson",
            # 255 = 2^8 - 1: coarsens 255->127->63->31->15 (5 levels); 16.6M rows
            grid=(255, 255, 255),
            source="BASELINE.json configs[3]",
        ),
        Workload(
            name="ladder_multihost_100m",
            description="ladder 5: row-partitioned ~100M-row MGCG, N>=2 hosts",
            policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"),
            builder="poisson",
            # 511 = 2^9 - 1; 133M rows
            grid=(511, 511, 511),
            source="BASELINE.json configs[4]",
        ),
    ]
}

#: the config ladder in ascending order
LADDER = [
    "ladder_dense_1k",
    "ladder_poisson2d_100k",
    "ladder_mgcg2d_1m",
    "ladder_mgcg3d_10m",
    "ladder_multihost_100m",
]


def get(name: str) -> Workload:
    try:
        return WORKLOADS[name]
    except KeyError:
        raise KeyError(f"unknown workload {name!r}; have {sorted(WORKLOADS)}") from None


def build(name: str, dtype=None) -> LinearSystem:
    return get(name).build(dtype=dtype)
