"""The CUDA kernels against their twins on the card.

Every test here needs a CUDA device and is marked ``gpu``; without one it
skips (the decision is taken inside the fixture, never at import).  Run on
the card with ``python -m pytest --noconftest tests/test_torch_cuda.py -q``
(``tests/conftest.py`` sets up JAX, which the GPU machine does not have).
"""

import itertools

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
    dia_to_stencil,
    stencil_to_const,
)
from conjugategradient_tpu_torch.ops import cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.ops.cuda_dia import (
    spmm_dia_acc_cuda,
    spmm_dia_acc_ref,
    spmm_dia_cuda,
    spmm_dia_ref,
    spmv_dia_cuda,
    spmv_dia_ref,
    spmv_dot_dia_cuda,
    spmv_dot_dia_ref,
)
from conjugategradient_tpu_torch.ops.cuda_stencil import (
    cheb_smooth_const_cuda,
    cheb_smooth_const_ref,
    spmv_const_stencil_cuda,
    spmv_const_stencil_ref,
    spmv_stencil_cuda,
    spmv_stencil_ref,
)
from conjugategradient_tpu_torch.precond.multigrid import (
    as_preconditioner,
    build_hierarchy,
    galerkin_coarse,
    v_cycle,
)
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.multi import as_multi_preconditioner
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

pytestmark = pytest.mark.gpu

#: same leg order in fp32; only FMA contraction differs
REL = 1e-5
#: the same in fp64
REL64 = 1e-13


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


#: kernel #2's edge grids: nz below the pipeline's stages, nz not a multiple
#: of the z chunk, nx and ny not multiples of the tile; the 7-point legs in
#: reverse order (the instantiation that reads its shifts at run time); a
#: 27-leg const-detected Galerkin level (the compile-time box pattern)
CHEB_EDGE = ["(3, 40, 70)", "(37, 20, 40)", "(37, 21, 45)", "(37, 21, 45) legs reversed",
             "(15, 15, 15) 27-leg Galerkin level"]


def _cheb_edge(case, device):
    """(operator, lam_min, lam_max, inv_diag) of a kernel #2 edge case."""
    if case.endswith("Galerkin level"):
        h = build_hierarchy(generators.poisson_system((31, 31, 31)).A, (31, 31, 31),
                            dtype=np.float32, device=device)
        lvl = h.levels[1]
        assert lvl.A.nlegs == 27 and lvl.grid == (15, 15, 15)
        return (lvl.A, *lvl.cheb_bounds, lvl.inv_diag)
    grid = tuple(int(v) for v in case.split(")")[0].strip("(").split(","))
    A = _const(grid)
    if case.endswith("legs reversed"):
        A = ConstStencilMatrix(A.coeffs[::-1], A.shifts[::-1], A.grid)
    return A, 0.5, 2.0, torch.tensor(1.0 / 6.0, device=device)


@pytest.mark.parametrize("case", CHEB_EDGE)
@pytest.mark.parametrize("degree", [1, 2, cuda_stencil.MAX_DEGREE])
@pytest.mark.parametrize("zero_x", [True, False])
@pytest.mark.parametrize("want_resid", [False, True])
def test_cheb_kernel_matches_twin_at_edge_grids(cuda, case, degree, zero_x, want_resid):
    A, lo, hi, invd = _cheb_edge(case, cuda)
    b, x0 = _rand(A.grid, 3, cuda), _rand(A.grid, 4, cuda)
    args = (A, b, None if zero_x else x0, degree, hi, lo, invd, want_resid)
    n0 = cheb_smooth_const_cuda.launches
    out, ref = cheb_smooth_const_cuda(*args), cheb_smooth_const_ref(*args)
    torch.cuda.synchronize()
    assert cheb_smooth_const_cuda.launches == n0 + 1
    for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
        assert float((o - r).abs().max()) <= REL * float(r.abs().max())


def _nan_carved_grid(grid, seed, device):
    """A grid tensor carved out of a NaN-filled buffer."""
    n = int(np.prod(grid))
    buf = torch.full((n + 2 * 4096,), float("nan"), device=device)
    x = buf[4096 : 4096 + n].view(grid)
    x.copy_(_rand(grid, seed, device))
    return x


@pytest.mark.parametrize("zero_x", [True, False])
@pytest.mark.parametrize("want_resid", [False, True])
def test_cheb_kernel_reads_nothing_outside_the_grid(cuda, zero_x, want_resid):
    # b and x0 lie between NaNs: a load outside the grid (or an operand not
    # zeroed outside the domain) would carry a NaN into an output
    grid = (37, 21, 45)
    A = _const(grid)
    b, x0 = _nan_carved_grid(grid, 5, cuda), _nan_carved_grid(grid, 6, cuda)
    args = (A, b, None if zero_x else x0, 2, 2.0, 0.5, torch.tensor(1.0 / 6.0, device=cuda),
            want_resid)
    out, ref = cheb_smooth_const_cuda(*args), cheb_smooth_const_ref(*args)
    torch.cuda.synchronize()
    for o, r in zip(out if want_resid else (out,), ref if want_resid else (ref,)):
        assert not bool(torch.isnan(r).any()) and not bool(torch.isnan(o).any())
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


def _dia(kind, dtype):
    """Host DIA matrices of the flat banded path: banded |sin|, ragged,
    tridiagonal and a 2-D Poisson operator as flat DIA."""
    A = {
        "banded": lambda: generators.banded_sin_matrix(5000, 160),
        "ragged": lambda: generators.banded_sin_matrix(333, 8),
        "tridiag": lambda: generators.tridiagonal_matrix(1023),
        "poisson2d": lambda: generators.poisson2d_matrix(61),
        "poisson3d": lambda: generators.poisson3d_matrix(31),
    }[kind]()
    return A.device_put(dtype, "cuda")


@pytest.mark.parametrize("kind", ["banded", "ragged", "tridiag", "poisson2d"])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_dia_spmv_kernels_match_twin(cuda, kind, legs):
    A = _dia(kind, legs)
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(A.n)).to(cuda, vec)
    cuda_dia.reset_launch_counts()
    y = spmv_dia_cuda(A, x)
    yf, dot = spmv_dot_dia_cuda(A, x)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches_by_dtype[cuda_dia.TAGS[legs]] == 1 and spmv_dot_dia_cuda.launches == 1
    ref, ref_dot = spmv_dot_dia_ref(A, x)
    assert y.dtype == ref.dtype == vec
    scale = float(ref.abs().max())
    assert float((y - ref).abs().max()) <= rel * scale
    assert torch.equal(yf, y)  # the fused kernel computes y by the same code
    assert abs(float(dot) - float(ref_dot)) <= rel * float((x.abs() * ref.abs()).sum())


@pytest.mark.parametrize("k", [1, 3, 4, 8, 11])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16])
def test_dia_spmm_kernel_matches_twin_and_spmv(cuda, k, legs):
    A = _dia("banded", legs)
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((k, A.n))).to(cuda, torch.float32)
    n0 = spmm_dia_cuda.launches
    Y = spmm_dia_cuda(A, X)
    torch.cuda.synchronize()
    assert spmm_dia_cuda.launches == n0 + len(cuda_dia.k_chunks(k))
    ref = spmm_dia_ref(A, X)
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    for j in range(k):  # each column is the single-RHS kernel's result, bit for bit
        assert torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous()))


def test_dia_kernels_raise_instead_of_falling_back(cuda):
    A = _dia("ragged", torch.float32)
    with pytest.raises(TypeError, match="no kernel"):
        spmv_dia_cuda(A, torch.zeros(A.n, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dia_cuda(A, torch.zeros((A.n, 2), device=cuda).T)
    with pytest.raises(TypeError, match="fp32 or bf16"):
        spmm_dia_cuda(_dia("ragged", torch.float64), torch.zeros((2, A.n), dtype=torch.float64,
                                                                  device=cuda))
    wide = DiaMatrix(torch.zeros((300, 400), device=cuda), tuple(range(-150, 150)), (400, 400))
    with pytest.raises(ValueError, match="diagonals"):
        spmv_dia_cuda(wide, torch.zeros(400, device=cuda))


def test_refined_flagship_contract_on_card_matches_cpu(cuda):
    from conjugategradient_tpu_torch.core import oracle
    from conjugategradient_tpu_torch.solvers.refine import refined_solve

    s = generators.banded_sin_system(4096, 32)
    out = {}
    for dev in ("cuda", "cpu"):
        cuda_dia.reset_launch_counts()
        out[dev] = refined_solve(s.A, s.b, s.x0, tol=1e-8, norm="l2", inner_tol=1e-4, device=dev)
        if dev == "cuda":
            r = out[dev]
            assert spmv_dia_cuda.launches == r.outer_iterations + r.inner_iterations
    g, c = out["cuda"], out["cpu"]
    assert g.converged and c.converged and g.outer_iterations == c.outer_iterations
    assert np.linalg.norm(s.b - oracle.spmv(s.A, g.x)) < 1e-8
    assert np.abs(g.x - c.x).max() <= 1e-7 * np.abs(c.x).max()


#: variable-coefficient stencils of kernel #3: 2-D/3-D diffusion operators
#: (5 and 7 legs) and Galerkin coarse levels of them (9 and 27 legs), on
#: ragged grids
VAR_CASES = {
    "5 legs (37, 53)": ((37, 53), None),
    "7 legs (23, 9, 12)": ((23, 9, 12), None),
    "7 legs (2, 3, 5)": ((2, 3, 5), None),
    "9 legs (19, 13)": ((39, 27), (19, 13)),
    "27 legs (11, 7, 5)": ((23, 15, 11), (11, 7, 5)),
}


def _var(case, legs, device):
    fine, coarse = VAR_CASES[case]
    A = generators.diffusion_system(fine, contrast=1e3).A
    grid = fine
    if coarse is not None:
        A, grid = galerkin_coarse(A, fine), coarse
    st = dia_to_stencil(A, grid)
    return st.device_put(legs, device)


@pytest.mark.parametrize("case", sorted(VAR_CASES))
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_var_stencil_kernel_matches_twin(cuda, case, legs):
    A = _var(case, legs, cuda)
    assert A.nlegs == int(case.split()[0])
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(A.grid)).to(cuda, vec)
    cuda_stencil.reset_launch_counts()
    y = spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    assert spmv_stencil_cuda.launches == 1 and spmv_stencil_cuda.launches_by_grid[A.grid] == 1
    assert spmv_stencil_cuda.launches_by_dtype[cuda_stencil.TAGS[legs]] == 1
    ref = spmv_stencil_ref(A, x)
    assert y.dtype == ref.dtype == vec
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("case", ["5 legs (37, 53)", "27 legs (11, 7, 5)"])
def test_var_stencil_kernel_reads_nothing_outside_the_grid(cuda, case):
    # x is carved out of a NaN-filled buffer, and NaNs are planted at grid
    # corners: a read past the grid (or across a row seam, where a leg is 0)
    # would leak a NaN where the twin has none (0 * NaN = NaN)
    A = _var(case, torch.float32, cuda)
    n = int(np.prod(A.grid))
    buf = torch.full((n + 2 * 4096,), float("nan"), device=cuda)
    x = buf[4096 : 4096 + n].view(A.grid)
    x.copy_(torch.from_numpy(np.random.default_rng(7).standard_normal(A.grid)).to(cuda, torch.float32))
    x[(0,) * len(A.grid)] = float("nan")
    x[tuple(g - 1 for g in A.grid)] = float("nan")
    y = spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    ref = spmv_stencil_ref(A, x)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert 0 < int(torch.isnan(ref).sum()) < n
    ok = ~torch.isnan(ref)
    assert float((y[ok] - ref[ok]).abs().max()) <= REL * float(ref[ok].abs().max())


SHIFTS27 = tuple(itertools.product((-1, 0, 1), repeat=3))
STAR7 = ((-1, 0, 0), (0, -1, 0), (0, 0, -1), (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 0))
#: hand-made stencils of kernel #3: two leg counts without an instantiation
#: of their own (13, 19), every specialised count on a grid that has an
#: interior block (3-D: more than two (32, 8) tiles and two 4-plane runs;
#: 2-D: more than two 256-wide rows and two 4-row runs), a grid of boundary
#: blocks only, and nz = 1
VAR_HAND = {
    "13 legs (10, 18, 66)": (SHIFTS27[:13], (10, 18, 66)),
    "19 legs (10, 18, 66)": (tuple(s for s in SHIFTS27 if sum(map(abs, s)) <= 2), (10, 18, 66)),
    "7 legs (10, 18, 66)": (STAR7, (10, 18, 66)),
    "27 legs (10, 18, 66)": (SHIFTS27, (10, 18, 66)),
    "7 legs (3, 3, 3)": (STAR7, (3, 3, 3)),
    "7 legs nz=1 (1, 17, 65)": (STAR7, (1, 17, 65)),
    "5 legs 2-D (40, 600)": (tuple(s[1:] for s in STAR7 if s[0] == 0), (40, 600)),
    "9 legs 2-D (40, 600)": (tuple(s[1:] for s in SHIFTS27 if s[0] == 0), (40, 600)),
}


@pytest.mark.parametrize("case", sorted(VAR_HAND))
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_var_stencil_kernel_matches_twin_on_hand_made_stencils(cuda, case, legs):
    shifts, grid = VAR_HAND[case]
    rng = np.random.default_rng(8)
    A = StencilMatrix(torch.from_numpy(rng.uniform(-1, 1, (len(shifts),) + grid)).to(cuda, legs),
                      shifts, grid)
    assert A.nlegs == int(case.split()[0])
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    x = torch.from_numpy(rng.standard_normal(grid)).to(cuda, vec)
    cuda_stencil.reset_launch_counts()
    y = spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    assert spmv_stencil_cuda.launches_by_dtype[cuda_stencil.TAGS[legs]] == 1
    ref = spmv_stencil_ref(A, x)
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


def test_var_stencil_kernel_raises_instead_of_falling_back(cuda):
    A = _var("7 legs (23, 9, 12)", torch.float32, cuda)
    with pytest.raises(TypeError, match="no kernel"):
        spmv_stencil_cuda(A, torch.zeros(A.grid, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmv_stencil_cuda(A, torch.zeros((12, 9, 23), device=cuda).transpose(0, 2))
    shifts = tuple((a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1) for c in (-1, 0, 1))
    wide = StencilMatrix(torch.zeros((28, 5, 5, 5), device=cuda), shifts + ((0, 0, 0),), (5, 5, 5))
    with pytest.raises(ValueError, match="legs supported"):
        spmv_stencil_cuda(wide, torch.zeros((5, 5, 5), device=cuda))


def test_galerkin_mgcg_on_card_matches_cpu(cuda):
    grid = (31, 31, 31)
    sys_ = generators.diffusion_system(grid, contrast=1e3)
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=8 * sys_.n)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        h = build_hierarchy(sys_.A, grid, dtype=np.float32, device=dev)
        b = torch.from_numpy(sys_.b).to(dev, torch.float32).reshape(grid)
        cuda_stencil.reset_launch_counts()
        out[dev.type] = cg_solve(h.levels[0].A, b, policy=pol, M=as_preconditioner(h),
                                 precise_dot=True)
        if dev.type == "cuda":
            assert all(spmv_stencil_cuda.launches_by_grid[l.grid] > 0 for l in h.levels)
    g, c = out["cuda"], out["cpu"]
    assert g.converged and c.converged and g.iterations == c.iterations
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-4


#: kernel #6 against kernel #5: the same fp32 sum rounded in two orders
#: (group partials, or one running sum)
ACC_VS_SPMM = 1e-6


@pytest.mark.parametrize("k", [1, 3, 4, 8, 11])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["banded", "poisson3d"])
def test_dia_spmm_acc_kernel_matches_twin_and_spmm(cuda, kind, legs, k):
    # band 160 takes four groups of <= 48 legs; 3-D Poisson's +-961 offsets
    # take three groups by the window limit
    A = _dia(kind, legs)
    X = torch.from_numpy(np.random.default_rng(8).standard_normal((k, A.n))).to(cuda, torch.float32)
    n0 = spmm_dia_acc_cuda.launches
    Y = spmm_dia_acc_cuda(A, X)
    torch.cuda.synchronize()
    assert spmm_dia_acc_cuda.launches == n0 + len(cuda_dia.k_chunks(k))
    ref = spmm_dia_acc_ref(A, X)
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    Y5 = spmm_dia_cuda(A, X)
    assert float((Y - Y5).abs().max()) <= ACC_VS_SPMM * float(Y5.abs().max())


@pytest.mark.parametrize("kind", ["banded", "poisson3d"])
def test_dia_spmm_acc_kernel_reads_nothing_outside_the_matrix(cuda, kind):
    # X is carved out of a NaN-filled buffer with NaNs planted at both ends
    # of every column: the rows the band reaches are NaN in the kernel and
    # the twin alike, the others stay finite
    A = _dia(kind, torch.float32)
    k, pad = 3, 4096
    buf = torch.full((k * A.n + 2 * pad,), float("nan"), device=cuda)
    X = buf[pad : pad + k * A.n].view(k, A.n)
    X.copy_(torch.from_numpy(np.random.default_rng(9).standard_normal((k, A.n))).to(cuda, torch.float32))
    X[:, 0] = float("nan")
    X[:, -1] = float("nan")
    Y = spmm_dia_acc_cuda(A, X)
    torch.cuda.synchronize()
    ref = spmm_dia_acc_ref(A, X)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(Y), nan) and 0 < int(nan.sum()) < nan.numel()
    assert float((Y[~nan] - ref[~nan]).abs().max()) <= REL * float(ref[~nan].abs().max())


def test_dia_spmm_acc_kernel_raises_instead_of_falling_back(cuda):
    A = _dia("ragged", torch.float32)
    with pytest.raises(TypeError, match="no kernel"):
        spmm_dia_acc_cuda(A, torch.zeros((2, A.n), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dia_acc_cuda(A, torch.zeros((A.n, 2), device=cuda).T)
    wide = DiaMatrix(torch.zeros((300, 400), device=cuda), tuple(range(-150, 150)), (400, 400))
    with pytest.raises(ValueError, match="diagonals"):
        spmm_dia_acc_cuda(wide, torch.zeros((2, 400), device=cuda))


@pytest.mark.parametrize("kind", ["poisson", "jump"])
def test_multi_preconditioner_on_card_is_v_cycle_per_column(cuda, kind):
    # Poisson's Galerkin levels const-detect (the fused smoother, kernel #2),
    # the jump field's stay variable (kernel #3)
    grid = (31, 31, 31)
    sys_ = (generators.poisson_system(grid) if kind == "poisson"
            else generators.diffusion_system(grid, contrast=1e3))
    h = build_hierarchy(sys_.A, grid, dtype=np.float32, device=cuda)
    R = torch.from_numpy(np.random.default_rng(10).standard_normal((sys_.n, 3))).to(cuda, torch.float32)
    cuda_stencil.reset_launch_counts()
    Z = as_multi_preconditioner(h)(R)
    torch.cuda.synchronize()
    launched = cheb_smooth_const_cuda.launches if kind == "poisson" else spmv_stencil_cuda.launches
    assert launched > 0
    assert Z.shape == R.shape
    for j in range(3):
        assert torch.equal(Z[:, j], v_cycle(h, R[:, j].contiguous()))
