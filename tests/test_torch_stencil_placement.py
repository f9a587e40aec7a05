"""A host ``StencilMatrix`` placed as the JAX package places it, on the CPU.

``api.solve(method="cg")`` in the JAX package calls ``A.device_put(dtype)``
on any container that has one, so a host stencil's fp64 legs become the
solve's dtype.  The port's facade does the same for a ``DiaMatrix`` and a
``StencilMatrix`` (single and ``(n, k)`` right-hand sides), and
``cg_solve`` / ``cg_solve_multi`` place a host container on ``b``'s device.
Here the same seeded jump-diffusion system goes through both facades in
fp32: the port's legs must be fp32 (the tree before the repair streamed the
host's fp64 legs, which kernel #3 refuses under fp32 state on the card) and
the iteration counts equal to the JAX package's.

The contrast is 10, not the 1e3 of the card runs: at 1e3 this grid takes
over 300 fp32 iterations and the count moves with the order of the fp32
dot products (the JAX package's own block CG takes 326 in column 0 where
its single solve takes 328), so no count there is a property of placement.
The twin casts each leg to the state's dtype as it reads it, so on the CPU
placement changes the legs' bytes, not the arithmetic.
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.formats import dia_to_stencil as j_dia_to_stencil
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import StencilMatrix, dia_to_stencil
from conjugategradient_tpu_torch.ops import stencil
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

GRID = (15, 13, 11)
CONTRAST = 10.0
KW = dict(method="cg", tol=1e-5, norm="rel_l2")
#: fp32 solutions of one recurrence in two packages: the order of a few
#: sums differs, relative to the largest entry
AGREE = 1e-3


def _systems():
    sj = jgen.diffusion_system(GRID, kind="jump", contrast=CONTRAST, seed=0)
    st = tgen.diffusion_system(GRID, kind="jump", contrast=CONTRAST, seed=0)
    return sj, st


@pytest.fixture
def leg_dtypes(monkeypatch):
    """Every leg dtype the variable-stencil products of ``ops.stencil`` see:
    kernel #3's wrapper (single right-hand side) and the twin that
    ``spmm_columns`` calls for CPU columns."""
    seen = []

    def spy(fn):
        def wrapped(A, x):
            seen.append(A.data.dtype)
            return fn(A, x)

        return wrapped

    for name in ("spmv_stencil_cuda", "spmv_stencil_ref"):
        monkeypatch.setattr(stencil, name, spy(getattr(stencil, name)))
    return seen


def test_facade_cg_places_a_host_stencil_at_the_solve_dtype(leg_dtypes):
    sj, st = _systems()
    ref = japi.solve(j_dia_to_stencil(sj.A, GRID), sj.b, dtype=np.float32, **KW)
    res = api.solve(dia_to_stencil(st.A, GRID), st.b, dtype=np.float32, device="cpu", **KW)
    assert int(ref.iterations) == 48  # the JAX package's count on this system
    assert res.iterations == int(ref.iterations) and res.converged
    assert res.x.dtype == torch.float32
    assert leg_dtypes and set(leg_dtypes) == {torch.float32}
    xj = np.asarray(ref.x)
    assert float(np.abs(res.x.numpy() - xj).max()) <= AGREE * float(np.abs(xj).max())


def test_facade_block_cg_places_a_host_stencil_at_the_solve_dtype(leg_dtypes):
    sj, st = _systems()
    rng = np.random.default_rng(5)
    B = np.column_stack([st.b, rng.standard_normal(st.n)])
    ref = japi.solve(j_dia_to_stencil(sj.A, GRID), B, dtype=np.float32, **KW)
    res = api.solve(dia_to_stencil(st.A, GRID), B, dtype=np.float32, device="cpu", **KW)
    assert np.asarray(ref.iterations).tolist() == [48, 64]
    assert res.iterations.tolist() == np.asarray(ref.iterations).tolist()
    assert bool(res.converged.all()) and res.x.dtype == torch.float32
    assert leg_dtypes and set(leg_dtypes) == {torch.float32}


@pytest.mark.parametrize("multi", [False, True])
def test_solvers_place_a_host_stencil_on_the_rhs_device(multi):
    # a host container follows b: legs on b's device, their dtype kept
    st = tgen.diffusion_system(GRID, kind="jump", contrast=1e3, seed=0)
    A = dia_to_stencil(st.A, GRID)
    placed = A.device_put(device="cpu")
    policy = ConvergencePolicy(tol=1e-8, norm="rel_l2")
    b = torch.from_numpy(st.b)
    if multi:
        B = torch.stack([b, torch.ones_like(b)], dim=1)
        got, want = cg_solve_multi(A, B, policy=policy), cg_solve_multi(placed, B, policy=policy)
        assert got.iterations.tolist() == want.iterations.tolist()
    else:
        got, want = cg_solve(A, b, policy=policy), cg_solve(placed, b, policy=policy)
        assert got.iterations == want.iterations
    assert torch.equal(got.x, want.x)
    assert isinstance(A.data, np.ndarray) and isinstance(placed, StencilMatrix)
