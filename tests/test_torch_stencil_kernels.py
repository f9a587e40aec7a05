"""The port's stencil kernel module (``ops/cuda_stencil.py``) on the CPU.

The plain twins are held to the JAX package's Pallas kernels run in
interpret mode, on the same inputs made from a numpy seed.  On the CPU the
wrappers must take the twins and launch nothing; their kernel-path argument
checks are exercised with tensors on the ``meta`` device, which is neither
the CPU nor CUDA, so the checks run and no kernel is needed.  The kernels
themselves are compared with the twins on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core.formats import dia_to_stencil as j_dia_to_stencil
from conjugategradient_tpu.core.formats import stencil_to_const as j_stencil_to_const
from conjugategradient_tpu.ops.pallas_stencil import (
    cheb_smooth_const_pallas,
    spmv_const_stencil_pallas,
)
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import ConstStencilMatrix, dia_to_stencil, stencil_to_const
from conjugategradient_tpu_torch.ops import cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    cheb_smooth_const_cuda,
    cheb_smooth_const_ref,
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
)
from conjugategradient_tpu_torch.ops.stencil import spmv_const_stencil


def _consts(grid):
    """(JAX, port) const-stencil Poisson operators of one grid, fp32."""
    jA = j_stencil_to_const(j_dia_to_stencil(jgen.poisson_system(grid, dtype=np.float32).A, grid))
    tA = stencil_to_const(dia_to_stencil(tgen.poisson_system(grid, dtype=np.float32).A, grid))
    assert jA.coeffs == tA.coeffs and jA.shifts == tA.shifts and jA.grid == tA.grid
    return jA, tA


@pytest.mark.parametrize(
    "grid", [(17, 13, 11), (33, 31, 29), (25, 19), (128, 128), (260, 31), (23, 9, 12)]
)
def test_spmv_twin_matches_pallas_interpret(grid):
    # fp32, same leg order: rtol = atol = 1e-6 as the Pallas kernel's own test
    import jax.numpy as jnp

    jA, tA = _consts(grid)
    x = np.random.default_rng(0).standard_normal(grid).astype(np.float32)
    y_j = np.asarray(spmv_const_stencil_pallas(jA, jnp.asarray(x), interpret=True))
    y_t = spmv_const_stencil_ref(tA, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(y_t, y_j, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("degree", [1, 2])
@pytest.mark.parametrize("zero_x", [True, False])
@pytest.mark.parametrize("want_resid", [False, True])
def test_cheb_twin_matches_pallas_interpret(degree, zero_x, want_resid):
    # all four variants; rtol = atol = 2e-5 as test_pallas_stencil.py's
    # fused-Chebyshev test
    import jax.numpy as jnp

    g = (24, 9, 12)
    jA, tA = _consts(g)
    invd = 1.0 / tA.coeffs[list(tA.shifts).index((0, 0, 0))]
    rng = np.random.default_rng(3)
    b = rng.standard_normal(g).astype(np.float32)
    x0 = rng.standard_normal(g).astype(np.float32)
    hi, lo = 1.9, 0.45
    out_j = cheb_smooth_const_pallas(
        jA, jnp.asarray(b), None if zero_x else jnp.asarray(x0), degree, hi, lo, invd,
        want_resid=want_resid, interpret=True,
    )
    out_t = cheb_smooth_const_ref(
        tA, torch.from_numpy(b), None if zero_x else torch.from_numpy(x0), degree, hi, lo,
        torch.tensor(invd, dtype=torch.float32), want_resid=want_resid,
    )
    out_j = out_j if want_resid else (out_j,)
    out_t = out_t if want_resid else (out_t,)
    for a, t in zip(out_j, out_t):
        np.testing.assert_allclose(t.numpy(), np.asarray(a), rtol=2e-5, atol=2e-5)


def test_cpu_wrappers_use_twins_and_launch_nothing():
    cuda_stencil.reset_launch_counts()
    g = (15, 9, 11)
    _, A = _consts(g)
    rng = np.random.default_rng(5)
    b = torch.from_numpy(rng.standard_normal(g).astype(np.float32))
    x0 = torch.from_numpy(rng.standard_normal(g).astype(np.float32))
    assert torch.equal(spmv_const_stencil_cuda(A, b), spmv_const_stencil_ref(A, b))
    for xin in (None, x0):
        for want_resid in (False, True):
            out = cheb_smooth_const_cuda(A, b, xin, 2, 2.0, 0.5, 1.0 / 6.0, want_resid)
            ref = cheb_smooth_const_ref(A, b, xin, 2, 2.0, 0.5, 1.0 / 6.0, want_resid)
            for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
                assert torch.equal(o, r)
    # fp64 on the CPU goes to the twin too
    assert spmv_const_stencil_cuda(A, b.double()).dtype == torch.float64
    # the operator takes flat vectors too, and refuses other shapes
    y_flat = spmv_const_stencil(A, b.reshape(-1))
    assert y_flat.shape == (b.numel(),)
    assert torch.equal(y_flat, spmv_const_stencil_ref(A, b).reshape(-1))
    with pytest.raises(ValueError, match="not compatible"):
        spmv_const_stencil(A, b[:-1])
    assert spmv_const_stencil_cuda.launches == 0
    assert cheb_smooth_const_cuda.launches == 0
    assert not cheb_smooth_const_cuda.launches_by_grid


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_kernel_path_rejects_what_the_kernels_do_not_take():
    _, A3 = _consts((9, 9, 9))
    A1 = ConstStencilMatrix((-1.0, 2.0, -1.0), ((-1,), (0,), (1,)), (65,))
    wide = ConstStencilMatrix((-1.0, 2.0, -1.0), ((-2, 0), (0, 0), (2, 0)), (9, 9))
    # kernel #1 takes 1-D, 2-D and 3-D grids in fp32 and fp64: every check
    # passes, and a meta tensor is refused only for not lying on the card
    for A, shape in ((A1, (65,)), (A3, (9, 9, 9))):
        for dtype in (torch.float32, torch.float64):
            with pytest.raises(ValueError, match="CUDA"):
                spmv_const_stencil_cuda(A, _meta(shape, dtype))
    # 4-D grid
    A4 = ConstStencilMatrix((1.0,), ((0, 0, 0, 0),), (3, 3, 3, 3))
    with pytest.raises(ValueError, match="1-D, 2-D or 3-D"):
        spmv_const_stencil_cuda(A4, _meta((3, 3, 3, 3)))
    # |shift| > 1
    with pytest.raises(ValueError, match="shifts"):
        spmv_const_stencil_cuda(wide, _meta((9, 9)))
    # more than 27 legs
    many = ConstStencilMatrix((1.0,) * 28, tuple((i % 3 - 1, 0, 0) for i in range(28)), (9, 9, 9))
    with pytest.raises(ValueError, match="legs supported"):
        spmv_const_stencil_cuda(many, _meta((9, 9, 9)))
    # neither fp32 nor fp64; the fused smoother takes fp32 only
    with pytest.raises(TypeError, match="float32 or float64"):
        spmv_const_stencil_cuda(A3, _meta((9, 9, 9), torch.bfloat16))
    with pytest.raises(TypeError, match="float32"):
        cheb_smooth_const_cuda(A3, _meta((9, 9, 9), torch.float64), None, 2, 2.0, 0.5, 1 / 6)
    # wrong rank / shape
    with pytest.raises(ValueError, match="not grid"):
        spmv_const_stencil_cuda(A3, _meta((729,)))
    # non-contiguous
    with pytest.raises(ValueError, match="contiguous"):
        spmv_const_stencil_cuda(A3, _meta((9, 9, 9)).transpose(0, 2))
    # a device that is neither the CPU nor CUDA
    with pytest.raises(ValueError, match="CUDA"):
        spmv_const_stencil_cuda(A3, _meta((9, 9, 9)))
    # the fused smoother: 3-D only, bounded degree, scalar inv_diag
    _, A2 = _consts((9, 9))
    with pytest.raises(ValueError, match="3-D"):
        cheb_smooth_const_cuda(A2, _meta((9, 9)), None, 2, 2.0, 0.5, 0.25)
    with pytest.raises(ValueError, match="degree"):
        cheb_smooth_const_cuda(A3, _meta((9, 9, 9)), None, cuda_stencil.MAX_DEGREE + 1, 2.0, 0.5, 1 / 6)
    assert spmv_const_stencil_cuda.launches == 0


def test_cheb_halo_matches_reference():
    from conjugategradient_tpu.ops.pallas_stencil import _cheb_halo

    for degree in range(1, cuda_stencil.MAX_DEGREE + 1):
        for zero_x in (True, False):
            for want_resid in (True, False):
                assert cuda_stencil._cheb_halo(degree, zero_x, want_resid) == _cheb_halo(
                    degree, zero_x, want_resid
                )
