"""The CUDA kernels against their twins on the card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips (the decision is taken inside the fixture, never at import).  Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` sets up JAX, which the GPU machine does not have).
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    cheb_smooth_const_cuda,
    cheb_smooth_const_ref,
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
)
from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner, build_hierarchy
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

pytestmark = pytest.mark.gpu

#: same leg order in fp32; only FMA contraction differs
REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")
    return torch.device("cuda", 0)


def _const(grid):
    return stencil_to_const(dia_to_stencil(generators.poisson_system(grid, dtype=np.float32).A, grid))


def _rand(grid, seed, device):
    x = np.random.default_rng(seed).standard_normal(grid).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("grid", [(37, 53), (2, 7), (64, 33), (23, 9, 12), (2, 3, 5), (40, 17, 70)])
def test_spmv_kernel_matches_twin(cuda, grid):
    A = _const(grid)
    x = _rand(grid, 0, cuda)
    n0 = spmv_const_stencil_cuda.launches
    y = spmv_const_stencil_cuda(A, x)
    torch.cuda.synchronize()
    ref = spmv_const_stencil_ref(A, x)
    assert spmv_const_stencil_cuda.launches == n0 + 1
    assert float((y - ref).abs().max()) <= REL * float(ref.abs().max())


@pytest.mark.parametrize("grid", [(24, 9, 12), (9, 9, 9), (17, 33, 70)])
@pytest.mark.parametrize("degree", [1, 2, cuda_stencil.MAX_DEGREE])
@pytest.mark.parametrize("zero_x", [True, False])
@pytest.mark.parametrize("want_resid", [False, True])
def test_cheb_kernel_matches_twin(cuda, grid, degree, zero_x, want_resid):
    A = _const(grid)
    b, x0 = _rand(grid, 1, cuda), _rand(grid, 2, cuda)
    invd = torch.tensor(1.0 / 6.0, device=cuda)
    args = (A, b, None if zero_x else x0, degree, 2.0, 0.5, invd, want_resid)
    out, ref = cheb_smooth_const_cuda(*args), cheb_smooth_const_ref(*args)
    torch.cuda.synchronize()
    for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
        assert float((o - r).abs().max()) <= REL * float(r.abs().max())


def test_cuda_path_raises_instead_of_falling_back(cuda):
    A = _const((9, 9, 9))
    with pytest.raises(TypeError, match="float32"):
        spmv_const_stencil_cuda(A, torch.zeros((9, 9, 9), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmv_const_stencil_cuda(A, torch.zeros((9, 9, 9), device=cuda).transpose(0, 1))
    with pytest.raises(ValueError, match="scalar"):
        cheb_smooth_const_cuda(A, torch.zeros((9, 9, 9), device=cuda), None, 2, 2.0, 0.5,
                               torch.ones(3, device=cuda))


@pytest.mark.parametrize("grid", [(63, 63), (31, 31, 31)])
def test_mgcg_on_card_matches_cpu(cuda, grid):
    sys_ = generators.poisson_system(grid, dtype=np.float32)
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=8 * sys_.n)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        h = build_hierarchy(sys_.A, grid, dtype=np.float32, device=dev,
                            coarse_operator=generators.poisson_coarse_operator(np.float32))
        b = torch.from_numpy(sys_.b).to(dev).reshape(grid)
        cuda_stencil.reset_launch_counts()
        out[dev.type] = cg_solve(h.levels[0].A, b, policy=pol, M=as_preconditioner(h),
                                 precise_dot=True)
        if dev.type == "cuda":
            assert spmv_const_stencil_cuda.launches > 0
            assert (cheb_smooth_const_cuda.launches > 0) == (len(grid) == 3)
    g, c = out["cuda"], out["cpu"]
    assert g.converged and c.converged and abs(g.iterations - c.iterations) <= 1
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-4
