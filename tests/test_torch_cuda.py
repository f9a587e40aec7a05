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

from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import (
    ConstStencilMatrix,
    DiaMatrix,
    StencilMatrix,
    dia_to_stencil,
    stencil_to_const,
)
from conjugategradient_tpu_torch.ops import _build, cuda_dia, cuda_stencil
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
    spmv_stencil_wide_cuda,
)
from conjugategradient_tpu_torch.precond.multigrid import (
    as_preconditioner,
    build_hierarchy,
    fmg,
    galerkin_coarse,
    mgcg_solve,
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("grid", [(37, 53), (2, 7), (64, 33), (23, 9, 12), (2, 3, 5), (40, 17, 70),
                                  (4095,), (7,), (13, 20, 70)])
def test_spmv_kernel_matches_twin(cuda, grid, dtype):
    A = _const(grid)
    x = _rand(grid, 0, cuda).to(dtype)
    rel = REL64 if dtype == torch.float64 else REL
    cuda_stencil.reset_launch_counts()
    y = spmv_const_stencil_cuda(A, x)
    torch.cuda.synchronize()
    ref = spmv_const_stencil_ref(A, x)
    assert spmv_const_stencil_cuda.launches == 1
    assert spmv_const_stencil_cuda.launches_by_grid[grid] == 1
    assert spmv_const_stencil_cuda.launches_by_dtype[cuda_stencil.TAGS[dtype]] == 1
    assert y.dtype == dtype
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


#: kernel #1's instantiations on random coefficients: every compile-time
#: pattern (on a grid with interior blocks and ragged edges in every axis,
#: nz = 1 for the 3-D ones), its legs reversed and a short leg list (the
#: run-time instantiation), and 1-D grids
_T = tuple(itertools.product((-1, 0, 1), repeat=3))
CONST_HAND = {
    "3-point 1-D (4095,)": (((-1,), (0,), (1,)), (4095,)),
    "3-point 1-D (300,)": (((-1,), (0,), (1,)), (300,)),
    "5-point 2-D (40, 600)": (((-1, 0), (0, -1), (0, 0), (0, 1), (1, 0)), (40, 600)),
    "9-point 2-D (41, 299)": (tuple(s[1:] for s in _T if s[0] == 0), (41, 299)),
    "7-point (13, 20, 70)": (tuple(s for s in _T if sum(map(abs, s)) <= 1), (13, 20, 70)),
    "7-point nz=1 (1, 17, 65)": (tuple(s for s in _T if sum(map(abs, s)) <= 1), (1, 17, 65)),
    "27-point (13, 20, 70)": (_T, (13, 20, 70)),
    "27-point nz=1 (1, 17, 65)": (_T, (1, 17, 65)),
    "7-point reversed (13, 20, 70)": (tuple(s for s in _T if sum(map(abs, s)) <= 1)[::-1], (13, 20, 70)),
    "5-point reversed 2-D (40, 600)": (((1, 0), (0, 1), (0, 0), (0, -1), (-1, 0)), (40, 600)),
    "2 legs 1-D (1000,)": (((0,), (1,)), (1000,)),
    "13 legs (13, 20, 70)": (_T[:13], (13, 20, 70)),
}


def _const_hand(case, device, dtype):
    shifts, grid = CONST_HAND[case]
    rng = np.random.default_rng(11)
    A = ConstStencilMatrix(tuple(float(c) for c in rng.uniform(-1, 1, len(shifts))), shifts, grid)
    return A, _rand(grid, 12, device).to(dtype)


@pytest.mark.parametrize("case", sorted(CONST_HAND))
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_spmv_kernel_matches_twin_on_every_pattern(cuda, case, dtype):
    A, x = _const_hand(case, cuda, dtype)
    spec = cuda_stencil.const_view(A.grid, A.shifts).spec
    assert (spec == 0) == ("reversed" in case or "legs" in case)
    y = spmv_const_stencil_cuda(A, x)
    torch.cuda.synchronize()
    ref = spmv_const_stencil_ref(A, x)
    rel = REL64 if dtype == torch.float64 else REL
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("case", sorted(CONST_HAND))
def test_spmv_kernel_reads_nothing_outside_the_grid(cuda, case):
    # x lies between NaNs: a read past the grid would leak a NaN where the
    # twin has none
    A, x = _const_hand(case, cuda, torch.float64)
    n = x.numel()
    buf = torch.full((n + 2 * 4096,), float("nan"), device=cuda, dtype=torch.float64)
    xc = buf[4096 : 4096 + n].view(A.grid)
    xc.copy_(x)
    y = spmv_const_stencil_cuda(A, xc)
    torch.cuda.synchronize()
    ref = spmv_const_stencil_ref(A, xc)
    assert not bool(torch.isnan(ref).any()) and not bool(torch.isnan(y).any())
    assert float((y - ref).abs().max()) <= REL64 * float(ref.abs().max())


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
    with pytest.raises(TypeError, match="float32 or float64"):
        spmv_const_stencil_cuda(A, torch.zeros((9, 9, 9), dtype=torch.bfloat16, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        cheb_smooth_const_cuda(A, torch.zeros((9, 9, 9), dtype=torch.float64, device=cuda), None,
                               2, 2.0, 0.5, torch.tensor(1 / 6, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmv_const_stencil_cuda(A, torch.zeros((9, 9, 9), device=cuda).transpose(0, 1))
    with pytest.raises(ValueError, match="scalar"):
        cheb_smooth_const_cuda(A, torch.zeros((9, 9, 9), device=cuda), None, 2, 2.0, 0.5,
                               torch.ones(3, device=cuda))


def test_const_kernel_takes_the_wrappers_geometry(cuda):
    # the library reports its z run (one plane for the 1-D pattern), and the
    # C entry launches the wrapper's block and grid, refusing one that does
    # not cover the view
    lib = _build.load("stencil")
    assert lib.cg_spmv_const_zrun(3) == 1 and lib.cg_spmv_const_zrun(7) >= 1
    A = _const((13, 20, 70))
    x = torch.randn(A.grid, device=cuda)
    view = cuda_stencil.const_view(A.grid, A.shifts)
    geo = cuda_stencil.const_geometry(view, lib.cg_spmv_const_zrun(view.spec))
    coeffs, shifts = cuda_stencil._const_args(tuple(float(c) for c in A.coeffs), view)
    y = torch.empty_like(x)
    short = (geo.grid[0], geo.grid[1], geo.grid[2] - 1)
    for block, grid, ok in ((geo.block, geo.grid, True), (geo.block, short, False),
                            ((32, 16), geo.grid, False)):
        err = lib.cg_spmv_const(0, view.spec, x.data_ptr(), y.data_ptr(), *view.dims, A.nlegs,
                                coeffs, shifts, *block, *grid, 0)
        assert (err == 0) == ok
    torch.cuda.synchronize()
    ref = spmv_const_stencil_ref(A, x)
    assert float((spmv_const_stencil_cuda(A, x) - ref).abs().max()) <= REL * float(ref.abs().max())


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


@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 11])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("kind", ["banded", "ragged", "poisson3d"])
def test_dia_spmm_kernel_matches_twin_and_spmv(cuda, kind, k, legs):
    A = _dia(kind, legs)
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    X = torch.from_numpy(np.random.default_rng(4).standard_normal((k, A.n))).to(cuda, vec)
    n0 = spmm_dia_cuda.launches
    Y = spmm_dia_cuda(A, X)
    torch.cuda.synchronize()
    assert spmm_dia_cuda.launches == n0 + len(cuda_dia.k_chunks(k))
    ref = spmm_dia_ref(A, X)
    assert Y.dtype == ref.dtype == vec
    assert float((Y - ref).abs().max()) <= rel * float(ref.abs().max())
    for j in range(k):  # each column is the single-RHS kernel's result, bit for bit
        assert torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous()))


@pytest.mark.parametrize("k", [3, 8])  # 8: the banded kinds stage X in shared memory
@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["banded", "ragged", "poisson3d"])
def test_dia_spmm_kernel_reads_nothing_outside_the_matrix(cuda, kind, legs, k):
    # X is carved out of a NaN-filled buffer with NaNs planted at both ends
    # of every column: the rows the band reaches are NaN in the kernel and
    # the twin alike, the others stay finite
    A = _dia(kind, legs)
    pad = 4096
    buf = torch.full((k * A.n + 2 * pad,), float("nan"), device=cuda, dtype=legs)
    X = buf[pad : pad + k * A.n].view(k, A.n)
    X.copy_(torch.from_numpy(np.random.default_rng(9).standard_normal((k, A.n))).to(cuda, legs))
    X[:, 0] = float("nan")
    X[:, -1] = float("nan")
    Y = spmm_dia_cuda(A, X)
    torch.cuda.synchronize()
    ref = spmm_dia_ref(A, X)
    nan = torch.isnan(ref)
    rel = REL64 if legs == torch.float64 else REL
    assert torch.equal(torch.isnan(Y), nan) and 0 < int(nan.sum()) < nan.numel()
    assert float((Y[~nan] - ref[~nan]).abs().max()) <= rel * float(ref[~nan].abs().max())


def test_dia_kernels_raise_instead_of_falling_back(cuda):
    A = _dia("ragged", torch.float32)
    with pytest.raises(TypeError, match="no kernel"):
        spmv_dia_cuda(A, torch.zeros(A.n, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dia_cuda(A, torch.zeros((A.n, 2), device=cuda).T)
    # kernel #5 takes fp64 legs with fp64 columns; kernel #6 refuses them
    A64 = _dia("ragged", torch.float64)
    X64 = torch.ones((2, A.n), dtype=torch.float64, device=cuda)
    assert torch.equal(spmm_dia_cuda(A64, X64)[1], spmv_dia_cuda(A64, X64[1].contiguous()))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        spmm_dia_acc_cuda(A64, X64)
    # more than 256 diagonals run in chained launches on #4 and #5; kernel
    # #6 and an empty matrix refuse
    wide = DiaMatrix(torch.ones((300, 400), device=cuda), tuple(range(-150, 150)), (400, 400))
    x = torch.ones(400, device=cuda)
    assert torch.equal(spmv_dia_cuda(wide, x), spmv_dia_ref(wide, x))
    with pytest.raises(ValueError, match="1..256 diagonals"):
        spmm_dia_acc_cuda(wide, torch.ones((2, 400), device=cuda))
    with pytest.raises(ValueError, match="got 0"):
        spmv_dia_cuda(DiaMatrix(torch.zeros((0, 400), device=cuda), (), (400, 400)), x)


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
    # past the wide kernel's legs (28 legs now take the wide kernel)
    n = cuda_stencil.WIDE_LEGS + 1
    wide = StencilMatrix(torch.zeros((n, 5, 5, 5), device=cuda), ((0, 0, 0),) * n, (5, 5, 5))
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


#: kernel #6's edge shapes (host DIA, random legs): fewer rows than one
#: tile; a group whose window crosses both ends of [0, n) in every block;
#: interior and border blocks with groups split by the window limit
ACC_EDGE = {
    "n=100 band 160": (100, tuple(range(-79, 80))),
    "n=200 one group crossing both ends": (200, (-150, -1, 0, 1, 150)),
    "n=3001 wide": (3001, (-900, -500, -3, 0, 2, 450, 700)),
}


def _acc_edge(case, legs):
    n, offsets = ACC_EDGE[case]
    data = np.random.default_rng(15).uniform(-1, 1, (len(offsets), n))
    return DiaMatrix(data, offsets, (n, n)).device_put(legs, "cuda")


def _nan_carved(X):
    """``X`` (k, n) copied into a NaN-filled buffer, NaNs planted at both
    ends of every column."""
    pad = 4096
    buf = torch.full((X.numel() + 2 * pad,), float("nan"), device=X.device, dtype=X.dtype)
    Xc = buf[pad : pad + X.numel()].view(X.shape)
    Xc.copy_(X)
    Xc[:, 0] = float("nan")
    Xc[:, -1] = float("nan")
    return Xc


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(ACC_EDGE))
def test_dia_spmm_acc_kernel_matches_twin_at_edge_shapes(cuda, case, legs, k):
    A = _acc_edge(case, legs)
    X = torch.from_numpy(np.random.default_rng(16).standard_normal((k, A.n))).to(cuda, torch.float32)
    Y = spmm_dia_acc_cuda(A, X)
    torch.cuda.synchronize()
    ref = spmm_dia_acc_ref(A, X)
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    Y5 = spmm_dia_cuda(A, X)
    assert float((Y - Y5).abs().max()) <= ACC_VS_SPMM * float(Y5.abs().max())


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("case", ["banded", "poisson3d", "n=200 one group crossing both ends",
                                  "n=3001 wide"])
def test_dia_spmm_acc_kernel_reads_nothing_outside_at_k(cuda, case, k):
    # interior blocks (banded, poisson3d) and border blocks alike: the rows
    # the band reaches from either planted end are NaN in kernel and twin
    # (at n = 100 band 160 it reaches every row: no finite row to compare)
    A = _dia(case, torch.float32) if case in ("banded", "poisson3d") else _acc_edge(case, torch.float32)
    X = _nan_carved(torch.from_numpy(np.random.default_rng(17).standard_normal((k, A.n))).to(
        cuda, torch.float32))
    Y = spmm_dia_acc_cuda(A, X)
    torch.cuda.synchronize()
    ref = spmm_dia_acc_ref(A, X)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(Y), nan) and 0 < int(nan.sum()) < nan.numel()
    assert float((Y[~nan] - ref[~nan]).abs().max()) <= REL * float(ref[~nan].abs().max())


def test_dia_spmm_acc_geometry_is_the_librarys(cuda):
    # the interior/border split the card tests rely on, at the library's tile
    lib = _build.load("dia")
    tile, stages = lib.cg_spmm_dia_acc_tile(), lib.cg_spmm_dia_acc_stages()
    for case, want in (("n=100 band 160", (1, 0)), ("n=3001 wide", None)):
        n, offsets = ACC_EDGE[case]
        geo = cuda_dia.acc_geometry(offsets, n, 8, tile, stages)
        if want is not None:
            assert (geo.blocks, geo.interior) == want
        else:
            assert 0 < geo.interior < geo.blocks
    A = _dia("banded", torch.float32)
    geo = cuda_dia.acc_geometry(tuple(A.offsets), A.n, 8, tile, stages)
    assert 0 < geo.interior < geo.blocks


@pytest.mark.parametrize("route", ["cg_solve", "api.solve"])
def test_host_stencil_solves_on_the_card(cuda, route):
    # a host StencilMatrix with a b on the card: its legs follow b to the
    # card (kernel #3, fp64 legs) and the solve takes the CPU's iterations
    # (contrast 10: at 1e3 the ~520 fp64 iterations move with FMA rounding)
    from conjugategradient_tpu_torch import api

    grid = (15, 13, 11)
    s = generators.diffusion_system(grid, kind="jump", contrast=10.0, seed=0)
    A = dia_to_stencil(s.A, grid)
    out = {}
    for dev in ("cuda", "cpu"):
        b = torch.from_numpy(s.b).to(dev)
        cuda_stencil.reset_launch_counts()
        if route == "cg_solve":
            out[dev] = cg_solve(A, b, policy=ConvergencePolicy(tol=1e-8, norm="rel_l2"))
        else:
            out[dev] = api.solve(A, b, method="cg", tol=1e-8, norm="rel_l2", device=dev)
        if dev == "cuda":
            assert spmv_stencil_cuda.launches_by_dtype["fp64"] > 0
    g, c = out["cuda"], out["cpu"]
    assert g.x.device.type == "cuda" and g.converged and c.converged
    assert g.iterations == c.iterations
    # two fp64 solves to rel_l2 1e-8 that round differently (FMA) agree to
    # the solve's tolerance, not to fp64 rounding (7e-10 measured)
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-8


def test_host_stencil_solves_on_the_card_in_fp32(cuda):
    # api.solve(dtype=np.float32) places the host legs at fp32 on the card
    from conjugategradient_tpu_torch import api

    grid = (15, 13, 11)
    s = generators.diffusion_system(grid, kind="jump", contrast=10.0, seed=0)
    kw = dict(method="cg", tol=1e-5, norm="rel_l2", dtype=np.float32)
    cuda_stencil.reset_launch_counts()
    g = api.solve(dia_to_stencil(s.A, grid), s.b, device=cuda, **kw)
    assert spmv_stencil_cuda.launches_by_dtype["fp32"] > 0
    c = api.solve(dia_to_stencil(s.A, grid), s.b, device="cpu", **kw)
    assert g.converged and g.x.dtype == torch.float32
    assert g.iterations == c.iterations  # 48 on the CPU, as in the JAX package


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


@pytest.mark.parametrize("grid", [(63, 63), (31, 31, 31), (4095,)])
def test_default_dtype_mgcg_on_card_matches_cpu(cuda, grid):
    # the generators' fp64 through api.solve with dtype=None: kernel #1 in
    # fp64 at every level (the fused smoother is fp32 only); 1-D above
    # max_coarse runs kernel #1's 1-D pattern
    from conjugategradient_tpu_torch import api

    s = generators.poisson_system(grid)
    out = {}
    for dev in ("cuda", "cpu"):
        cuda_stencil.reset_launch_counts()
        out[dev] = api.solve(s.A, s.b, method="mgcg", grid=grid, tol=1e-10, norm="rel_l2",
                             device=dev)
        if dev == "cuda":
            assert spmv_const_stencil_cuda.launches_by_dtype["fp64"] > 0
            assert cheb_smooth_const_cuda.launches == 0
    g, c = out["cuda"], out["cpu"]
    assert g.x.dtype == torch.float64 and g.converged and c.converged
    assert g.iterations == c.iterations
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-10


def test_fp64_block_cg_on_card_matches_cpu(cuda):
    from conjugategradient_tpu_torch import api

    s = generators.banded_sin_system(4096, 32)
    B = np.column_stack([s.b] + [np.random.default_rng(j).standard_normal(s.n) for j in range(2)])
    out = {}
    for dev in ("cuda", "cpu"):
        cuda_dia.reset_launch_counts()
        out[dev] = api.solve(s.A, B, method="cg", tol=1e-8, norm="rel_l2", device=dev)
        if dev == "cuda":
            assert spmm_dia_cuda.launches_by_dtype["fp64"] > 0
    g, c = out["cuda"], out["cpu"]
    assert bool(g.converged.all()) and bool(c.converged.all())
    assert g.iterations.tolist() == c.iterations.tolist()
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-10


def test_entry_points_take_a_b_already_on_the_card(cuda):
    # the same data as a CUDA tensor and as numpy: the same result
    from conjugategradient_tpu_torch.precond.multigrid import mgcg_solve
    from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi

    grid = (31, 31, 31)
    s = generators.poisson_system(grid)
    b_dev = torch.from_numpy(s.b).to(cuda)
    x0 = np.random.default_rng(13).standard_normal(s.n) * 1e-3
    h = build_hierarchy(s.A, grid, dtype=np.float32, device=cuda)
    kw = dict(grid=grid, x0=None, hierarchy=h, policy=ConvergencePolicy(tol=1e-6, norm="rel_l2"))
    for x0_in in (None, x0):
        kw["x0"] = x0_in
        r_np, _ = mgcg_solve(s.A, s.b, **kw)
        kw["x0"] = None if x0_in is None else torch.from_numpy(x0_in).to(cuda)
        r_dev, _ = mgcg_solve(s.A, b_dev, **kw)
        assert r_np.iterations == r_dev.iterations and torch.equal(r_np.x, r_dev.x)
    f = generators.banded_sin_system(4096, 32)
    fb = torch.from_numpy(f.b).to(cuda)
    fx0 = torch.from_numpy(f.x0).to(cuda)
    for kwr in ({}, dict(device_residual=True)):
        a = refined_solve(f.A, f.b, f.x0, tol=1e-8, device=cuda, **kwr)
        d = refined_solve(f.A, fb, fx0, tol=1e-8, device=cuda, **kwr)
        assert a.converged and np.array_equal(a.x, d.x) and a.history == d.history
    B = np.column_stack([f.b, 2 * f.b])
    a = refined_solve_multi(f.A, B, tol=1e-8, device=cuda)
    d = refined_solve_multi(f.A, torch.from_numpy(B).to(cuda), tol=1e-8, device=cuda)
    assert bool(a.converged.all()) and np.array_equal(a.x, d.x)


#: the wide kernel #3's hand-made stencils (random legs): every shift of
#: the halo-2 box on 1-D, 2-D and 3-D grids, each rank's Galerkin leg
#: counts (1-D 5, 2-D 21 and 25, 3-D 81 and 125), the smoothed-aggregation
#: levels' halo-3 and halo-5 boxes (343 and 1331 legs), odd and even
#: extents, nz = 1, grids smaller than the halo, and leg counts that are
#: not a multiple of the kernel's group of 8
_BOX1 = tuple((s,) for s in range(-2, 3))
_BOX2 = tuple(itertools.product(range(-2, 3), repeat=2))
_BOX3 = tuple(itertools.product(range(-2, 3), repeat=3))
WIDE_HAND = {
    "5 legs 1-D (4097,)": (_BOX1, (4097,)),
    "5 legs 1-D (3,)": (_BOX1, (3,)),
    "21 legs 2-D (63, 64)": (tuple(s for s in _BOX2 if abs(s[0]) + abs(s[1]) < 4), (63, 64)),
    "25 legs 2-D (40, 600)": (_BOX2, (40, 600)),
    "25 legs 2-D nz=1 (1, 300)": (_BOX2, (1, 300)),
    "49 legs 2-D halo 3 (33, 70)": (tuple(itertools.product(range(-3, 4), repeat=2)), (33, 70)),
    "81 legs 3-D (17, 16, 33)": (_BOX3[22:103], (17, 16, 33)),
    "125 legs 3-D (9, 10, 11)": (_BOX3, (9, 10, 11)),
    "125 legs 3-D (2, 3, 4)": (_BOX3, (2, 3, 4)),
    "28 legs 3-D (12, 9, 40)": (SHIFTS27 + ((0, 0, 2),), (12, 9, 40)),
    "343 legs 3-D halo 3 (9, 10, 11)": (tuple(itertools.product(range(-3, 4), repeat=3)), (9, 10, 11)),
    "1331 legs 3-D halo 5 (12, 11, 13)": (tuple(itertools.product(range(-5, 6), repeat=3)),
                                          (12, 11, 13)),
    "15 legs 1-D halo 7 (100,)": (tuple((s,) for s in range(-7, 8)), (100,)),
}


def _wide(case, legs, device, seed=11):
    shifts, grid = WIDE_HAND[case]
    rng = np.random.default_rng(seed)
    return StencilMatrix(torch.from_numpy(rng.uniform(-1, 1, (len(shifts),) + grid)).to(device, legs),
                         shifts, grid)


@pytest.mark.parametrize("case", sorted(WIDE_HAND))
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_wide_var_kernel_matches_twin(cuda, case, legs):
    A = _wide(case, legs, cuda)
    assert A.nlegs == int(case.split()[0])
    assert cuda_stencil.var_route(A) == "wide"
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(A.grid)).to(cuda, vec)
    cuda_stencil.reset_launch_counts()
    y = spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    assert spmv_stencil_cuda.launches == 0
    assert spmv_stencil_wide_cuda.launches == 1 and spmv_stencil_wide_cuda.launches_by_grid[A.grid] == 1
    assert spmv_stencil_wide_cuda.launches_by_dtype[cuda_stencil.TAGS[legs]] == 1
    ref = spmv_stencil_ref(A, x)
    assert y.dtype == ref.dtype == vec
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("case", sorted(c for c in WIDE_HAND if np.prod(WIDE_HAND[c][1]) > 100))
def test_wide_var_kernel_reads_nothing_outside_the_grid(cuda, case):
    # (on the tiniest grids the two planted NaNs reach every point)
    # x carved out of a NaN-filled buffer, NaNs planted at both grid corners:
    # a read past the grid, or across a row seam, would leak a NaN where the
    # twin has none
    A = _wide(case, torch.float32, cuda)
    n = int(np.prod(A.grid))
    buf = torch.full((n + 2 * 4096,), float("nan"), device=cuda)
    x = buf[4096 : 4096 + n].view(A.grid)
    x.copy_(torch.from_numpy(np.random.default_rng(13).standard_normal(A.grid)).to(cuda, torch.float32))
    x[(0,) * len(A.grid)] = float("nan")
    x[tuple(g - 1 for g in A.grid)] = float("nan")
    y = spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    ref = spmv_stencil_ref(A, x)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert 0 < int(torch.isnan(ref).sum()) < n
    ok = ~torch.isnan(ref)
    assert float((y[ok] - ref[ok]).abs().max()) <= REL * float(ref[ok].abs().max())


def _wide_split(A, x, split):
    """The wide kernel on checked arguments with a forced split of its legs
    (``"most"``: the largest a block of one row of points holds)."""
    view = cuda_stencil.wide_view(tuple(A.grid), tuple(A.shifts))
    most = cuda_stencil.WIDE_MAX_THREADS // cuda_stencil.wide_geometry(view, 1).block[0]
    split = min(A.nlegs, most if split == "most" else split)
    code = cuda_stencil._check_var_args("test", A, x)
    return cuda_stencil._wide_launch(_build.load("stencil_var"), code, A, x, view,
                                     cuda_stencil._wide_table(view, x.device),
                                     cuda_stencil.wide_geometry(view, A.nlegs, split=split))


@pytest.mark.parametrize("split", [1, 3, "most"])
@pytest.mark.parametrize("case", sorted(WIDE_HAND))
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_wide_var_kernel_matches_twin_under_a_split(cuda, case, legs, split):
    # split 1 sums the twin's order; a split > 1 groups the sum by slice
    A = _wide(case, legs, cuda)
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(A.grid)).to(cuda, vec)
    y = _wide_split(A, x, split)
    torch.cuda.synchronize()
    ref = spmv_stencil_ref(A, x)
    assert y.dtype == ref.dtype == vec
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


@pytest.mark.parametrize("split", [1, "most"])
@pytest.mark.parametrize("case", sorted(c for c in WIDE_HAND if np.prod(WIDE_HAND[c][1]) > 100))
def test_wide_var_kernel_reads_nothing_outside_the_grid_under_a_split(cuda, case, split):
    # test_wide_var_kernel_reads_nothing_outside_the_grid with the legs
    # split across threads
    A = _wide(case, torch.float32, cuda)
    n = int(np.prod(A.grid))
    buf = torch.full((n + 2 * 4096,), float("nan"), device=cuda)
    x = buf[4096 : 4096 + n].view(A.grid)
    x.copy_(torch.from_numpy(np.random.default_rng(13).standard_normal(A.grid)).to(cuda, torch.float32))
    x[(0,) * len(A.grid)] = float("nan")
    x[tuple(g - 1 for g in A.grid)] = float("nan")
    y = _wide_split(A, x, split)
    torch.cuda.synchronize()
    ref = spmv_stencil_ref(A, x)
    assert torch.equal(torch.isnan(y), torch.isnan(ref))
    assert 0 < int(torch.isnan(ref).sum()) < n
    ok = ~torch.isnan(ref)
    assert float((y[ok] - ref[ok]).abs().max()) <= REL * float(ref[ok].abs().max())


def test_wide_kernel_refuses_a_launch_that_does_not_cover_the_grid(cuda):
    # the C entry takes the wrapper's geometry as given and raises on one
    # that misses a block or a slice too many; nothing falls back
    A = _wide("343 legs 3-D halo 3 (9, 10, 11)", torch.float32, cuda)
    x = torch.zeros(A.grid, device=cuda)
    view = cuda_stencil.wide_view(tuple(A.grid), tuple(A.shifts))
    table = cuda_stencil._wide_table(view, x.device)
    lib = _build.load("stencil_var")
    geo = cuda_stencil.wide_geometry(view, A.nlegs, split=8)
    y = cuda_stencil._wide_launch(lib, 0, A, x, view, table, geo)
    torch.cuda.synchronize()
    assert float(y.abs().max()) == 0.0
    for bad in (geo._replace(grid=(geo.grid[0], geo.grid[1] - 1, geo.grid[2])),
                geo._replace(grid=(geo.grid[0], geo.grid[1], geo.grid[2] + 1)),
                geo._replace(split=64), geo._replace(split=A.nlegs + 1), geo._replace(zrun=4)):
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            cuda_stencil._wide_launch(lib, 0, A, x, view, table, bad)


@pytest.mark.parametrize("case", sorted(VAR_HAND))
def test_wide_var_kernel_matches_the_tuned_kernel_at_halo_1(cuda, case):
    shifts, grid = VAR_HAND[case]
    rng = np.random.default_rng(14)
    A = StencilMatrix(torch.from_numpy(rng.uniform(-1, 1, (len(shifts),) + grid)).to(cuda, torch.float64),
                      shifts, grid)
    x = torch.from_numpy(rng.standard_normal(grid)).to(cuda)
    y_w, y_t = spmv_stencil_wide_cuda(A, x), spmv_stencil_cuda(A, x)
    torch.cuda.synchronize()
    assert float((y_w - y_t).abs().max()) <= REL64 * float(y_t.abs().max())


#: the new transfer kinds' systems, small: (label, system, grid, build kw)
KINDS = {
    "hyb + agg Poisson 32^3": (lambda: generators.poisson_system((32, 32, 32)), (32, 32, 32), {}),
    "semi anisotropic 128^2": (lambda: generators.anisotropic_diffusion_system((128, 128), (1e-3, 1.0)),
                               (128, 128), {}),
    "agg tridiagonal 4096": (lambda: generators.tridiagonal_system(4096), (4096,), {}),
    "dia layout Poisson 64^2": (lambda: generators.poisson_system((64, 64)), (64, 64),
                                dict(layout="dia")),
    "rbgs Poisson 64^2": (lambda: generators.poisson_system((64, 64)), (64, 64),
                          dict(smoother="rbgs")),
}


@pytest.mark.parametrize("case", sorted(KINDS))
@pytest.mark.parametrize("gamma", [1, 2])
def test_new_transfer_kinds_mgcg_on_card_match_cpu(cuda, case, gamma):
    make, grid, kw = KINDS[case]
    s = make()
    out = {}
    for dev in ("cuda", "cpu"):
        cuda_stencil.reset_launch_counts()
        cuda_dia.reset_launch_counts()
        out[dev], h = mgcg_solve(s.A, s.b, grid, policy=ConvergencePolicy(tol=1e-10, norm="rel_l2"),
                                 gamma=gamma, device=dev, **kw)
        if dev == "cuda":
            launched = (spmv_const_stencil_cuda.launches + spmv_stencil_cuda.launches
                        + spmv_stencil_wide_cuda.launches + spmv_dia_cuda.launches)
            assert launched > 0
            if kw.get("layout") == "dia":
                assert spmv_dia_cuda.launches > 0
            elif any(cuda_stencil.var_route(l.A) == "wide" for l in h.levels
                     if isinstance(l.A, StencilMatrix)):
                assert spmv_stencil_wide_cuda.launches > 0
    g, c = out["cuda"], out["cpu"]
    assert g.converged and c.converged and g.iterations == c.iterations
    assert float((g.x.cpu() - c.x).abs().max() / c.x.abs().max()) <= 1e-10


def test_fmg_on_card_matches_cpu(cuda):
    grid = (64, 64)
    s = generators.poisson_system(grid)
    x = {}
    for dev in ("cuda", "cpu"):
        h = build_hierarchy(s.A, grid, device=dev)
        x[dev] = fmg(h, torch.from_numpy(s.b).to(dev)).cpu()
    assert float((x["cuda"] - x["cpu"]).abs().max() / x["cpu"].abs().max()) <= 1e-12


# -- kernels #4 and #5 past 256 diagonals; every format on the card ---------

def _many_diagonals(case):
    """A DIA matrix with more than 256 diagonals: a band of 300 offsets, or
    a random 7^3- or 11^3-leg stencil on 16^3 (the 16^3 levels of the 128^3
    and 256^3 DIA-layout hierarchies carry 343 and 1331), or the 7^3 one on
    32^3 (32,768 rows)."""
    rng = np.random.default_rng(len(case))
    if case == "band 300":
        n, offs = 4000, tuple(range(-150, 150))
    else:
        g, h = {"16^3 x 343": (16, 3), "16^3 x 1331": (16, 5), "32^3 x 343": (32, 3)}[case]
        n = g ** 3
        offs = tuple(sorted({(a * g + b) * g + c for a in range(-h, h + 1)
                             for b in range(-h, h + 1) for c in range(-h, h + 1)}))
    data = rng.standard_normal((len(offs), n))
    i = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    return DiaMatrix(data, offs, (n, n))


def _in_nan_buffer(X):
    """``X`` copied into the middle of a NaN-filled buffer: a read past
    [0, n) leaks a NaN."""
    pad = 8192
    buf = torch.full((X.numel() + 2 * pad,), float("nan"), dtype=X.dtype, device=X.device)
    Xc = buf[pad : pad + X.numel()].view(X.shape)
    Xc.copy_(X)
    return Xc


@pytest.mark.parametrize("case", ["band 300", "16^3 x 343", "16^3 x 1331"])
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_dia_kernels_past_256_diagonals_match_twin(cuda, case, legs):
    A = _many_diagonals(case).device_put(legs, cuda)
    groups = len(cuda_dia.dia_groups(A.ndiags))
    assert groups > 1
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    gen = torch.Generator(device=cuda).manual_seed(A.ndiags)
    x = _in_nan_buffer(torch.randn(A.n, generator=gen, device=cuda, dtype=vec))
    cuda_dia.reset_launch_counts()
    y, ref = spmv_dia_cuda(A, x), spmv_dia_ref(A, x)
    yf, dot = spmv_dot_dia_cuda(A, x)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches == spmv_dot_dia_cuda.launches == groups
    assert spmv_dia_cuda.launches_by_shape == {(A.n, A.ndiags): groups}
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())
    assert torch.equal(yf, y)
    assert abs(float(dot) - float(torch.dot(x, ref))) <= rel * float((x * ref).abs().sum())
    for k in (1, 3, 4, 8):
        X = _in_nan_buffer(torch.randn((k, A.n), generator=gen, device=cuda, dtype=vec))
        n0 = spmm_dia_cuda.launches
        Y, Yr = spmm_dia_cuda(A, X), spmm_dia_ref(A, X)
        torch.cuda.synchronize()
        assert spmm_dia_cuda.launches - n0 == groups * len(cuda_dia.spmm_chunks(A, k))
        assert float((Y - Yr).abs().max()) <= rel * float(Yr.abs().max()), k
        for j in range(k):
            assert torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous())), (k, j)


SPLIT_CASES = ["band 300", "16^3 x 343", "16^3 x 1331", "32^3 x 343"]


@pytest.mark.parametrize("case", SPLIT_CASES)
@pytest.mark.parametrize("legs", [torch.float32, torch.bfloat16, torch.float64])
def test_dia_split_kernels_match_twin_and_emulation(cuda, case, legs):
    # the split #4, its fused p.Ap and the chained #5 take the plan's S > 1;
    # the emulation (tests/test_torch_dia_split.py) replays the same launches
    # in fp64 on the CPU
    from test_torch_dia_split import dia_schedule, dot_schedule

    A = _many_diagonals(case).device_put(legs, cuda)
    plan = cuda_dia.dia_plan(A.n, A.ndiags)
    assert plan.split > 1
    A64 = DiaMatrix(A.data.double().cpu(), A.offsets, A.shape)
    vec = torch.float64 if legs == torch.float64 else torch.float32
    rel = REL64 if legs == torch.float64 else REL
    gen = torch.Generator(device=cuda).manual_seed(A.ndiags + 1)
    x = _in_nan_buffer(torch.randn(A.n, generator=gen, device=cuda, dtype=vec))
    y, ref = spmv_dia_cuda(A, x), spmv_dia_ref(A, x)
    yf, dot = spmv_dot_dia_cuda(A, x)
    torch.cuda.synchronize()
    emu = dia_schedule(A64, x.double().cpu()[None], plan)[0]
    _, dot_emu = dot_schedule(emu, x.double().cpu(), plan)
    for want in (ref, emu):
        assert float((y.double().cpu() - want.double().cpu()).abs().max()) \
            <= rel * float(want.abs().max())
    assert torch.equal(yf, y)
    scale = float((x.double().cpu() * emu).abs().sum())
    assert abs(float(dot) - float(dot_emu)) <= rel * scale
    for k in (1, 3, 4, 8):
        X = _in_nan_buffer(torch.randn((k, A.n), generator=gen, device=cuda, dtype=vec))
        Y, Yr = spmm_dia_cuda(A, X), spmm_dia_ref(A, X)
        torch.cuda.synchronize()
        Ye = dia_schedule(A64, X.double().cpu(), plan)
        for want in (Yr, Ye):
            assert float((Y.double().cpu() - want.double().cpu()).abs().max()) \
                <= rel * float(want.abs().max()), k
        for j in range(k):
            assert torch.equal(Y[j], spmv_dia_cuda(A, X[j].contiguous())), (k, j)


@pytest.mark.parametrize("split", [1, 3, 32])
@pytest.mark.parametrize("case", ["band 300", "16^3 x 1331"])
@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
def test_dia_kernels_match_twin_under_a_forced_split(cuda, case, legs, split):
    # any split the kernels take, the plan's or not; at S = 1 the unsplit
    # chain
    A = _many_diagonals(case).device_put(legs, cuda)
    plan = cuda_dia.dia_plan(A.n, A.ndiags, split=split)
    lib, code = _build.load("dia"), cuda_dia._CODES[(legs, legs)]
    rel = REL64 if legs == torch.float64 else REL
    gen = torch.Generator(device=cuda).manual_seed(split)
    x = _in_nan_buffer(torch.randn(A.n, generator=gen, device=cuda, dtype=legs))
    X = _in_nan_buffer(torch.randn((4, A.n), generator=gen, device=cuda, dtype=legs))
    y, _ = cuda_dia._spmv_launch(lib, code, A, x, plan)
    yf, dot = cuda_dia._spmv_launch(lib, code, A, x, plan, dot=True)
    Y = cuda_dia._spmm_launch(lib, code, A, X, plan)
    torch.cuda.synchronize()
    ref, Yr = spmv_dia_ref(A, x), spmm_dia_ref(A, X)
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())
    assert torch.equal(yf, y)
    assert abs(float(dot) - float(torch.dot(x, ref))) <= rel * float((x * ref).abs().sum())
    assert float((Y - Yr).abs().max()) <= rel * float(Yr.abs().max())
    for j in range(4):
        assert torch.equal(Y[j], cuda_dia._spmv_launch(lib, code, A, X[j].contiguous(), plan)[0])


@pytest.mark.parametrize("case", ["16^3 x 343", "16^3 x 1331"])
def test_dia_split_kernels_replay_from_a_graph(cuda, case):
    # a chained split launch is a programmatic dependent launch; replayed
    # from a CUDA graph the chain gives the eager numbers bit for bit
    A = _many_diagonals(case).device_put(torch.float64, cuda)
    gen = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(A.n, generator=gen, device=cuda, dtype=torch.float64)
    X = torch.randn((4, A.n), generator=gen, device=cuda, dtype=torch.float64)
    run = lambda: (spmv_dia_cuda(A, x), *spmv_dot_dia_cuda(A, x), spmm_dia_cuda(A, X))
    run()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run()
    for _ in range(2):
        x.copy_(torch.randn(A.n, generator=gen, device=cuda, dtype=torch.float64))
        X.copy_(torch.randn((4, A.n), generator=gen, device=cuda, dtype=torch.float64))
        graph.replay()
        torch.cuda.synchronize()
        for got, want in zip(outs, run()):
            assert torch.equal(got, want)


def test_dia_layout_mgcg_past_256_diagonals_converges(cuda):
    """The 128^3 DIA-layout hierarchy's 16^3 level carries 343 diagonals;
    kernel #4 refused it before its launches were chained."""
    from conjugategradient_tpu_torch import api

    g = (128, 128, 128)
    s = generators.poisson_system(g, dtype=np.float32)
    h = build_hierarchy(s.A, g, layout="dia", dtype=np.float32, device=cuda)
    assert max(lvl.A.ndiags for lvl in h.levels) == 343
    cuda_dia.reset_launch_counts()
    res = api.solve(s.A, s.b, method="mgcg", grid=g, layout="dia", hierarchy=h, tol=1e-6,
                    norm="rel_l2", dtype=np.float32, device=cuda)
    torch.cuda.synchronize()
    assert res.converged and spmv_dia_cuda.launches > 0
    x = res.x.double().cpu().numpy()
    A64 = s.A.astype(np.float64)
    from conjugategradient_tpu_torch.core import oracle

    b = np.asarray(s.b, np.float64)
    assert np.linalg.norm(b - oracle.spmv(A64, x)) / np.linalg.norm(b) <= 1e-5


def _format_cases():
    from conjugategradient_tpu_torch.core import formats as F

    A = generators.banded_sin_matrix(8192, 160)
    csr = F.dia_to_csr(A)
    return {"csr": csr, "ell": F.csr_to_ell(csr), "coo": F.csr_to_coo(csr),
            "bsr": F.csr_to_bsr(csr, (8, 8)), "dense": F.csr_to_dense(csr), "dia": A}


@pytest.mark.parametrize("fmt", ["csr", "ell", "coo", "bsr", "dense", "dia"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_format_products_on_card_match_oracle(cuda, fmt, dtype):
    from conjugategradient_tpu_torch.core import oracle
    from conjugategradient_tpu_torch.ops.spmm import spmm
    from conjugategradient_tpu_torch.ops.spmv import spmv

    A = _format_cases()[fmt]
    rng = np.random.default_rng(3)
    x, X = rng.standard_normal(A.n), rng.standard_normal((A.n, 4))
    ref = oracle.spmv(A, x)
    refX = np.stack([oracle.spmv(A, X[:, j]) for j in range(4)], axis=1)
    Ad = A.device_put(dtype, cuda)
    y = spmv(Ad, torch.from_numpy(x).to(cuda, dtype))
    Y = spmm(Ad, torch.from_numpy(X).to(cuda, dtype))
    assert y.device.type == Y.device.type == "cuda" and y.dtype == Y.dtype == dtype
    rel = 1e-5 if dtype == torch.float32 else 1e-12
    assert np.abs(y.cpu().numpy() - ref).max() <= rel * np.abs(ref).max()
    assert np.abs(Y.cpu().numpy() - refX).max() <= rel * np.abs(refX).max()
    if fmt in ("ell", "dense", "dia"):  # cuSPARSE (CSR, COO, BSR) promises no such thing
        assert torch.equal(spmv(Ad, torch.from_numpy(x).to(cuda, dtype)), y)


@pytest.mark.parametrize("route", ["cg_solve", "api.solve", "api.solve block"])
def test_host_csr_solves_on_the_card(cuda, route):
    from conjugategradient_tpu_torch import api
    from conjugategradient_tpu_torch.core import formats as F
    from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi

    s = generators.banded_sin_system(4096, 32)
    csr = F.dia_to_csr(s.A)
    b = torch.from_numpy(s.b).to(cuda)
    if route == "cg_solve":
        res, ref = cg_solve(csr, b), cg_solve(csr, b.cpu())
    elif route == "api.solve":
        res, ref = api.solve(csr, b), api.solve(csr, s.b, device="cpu")
    else:
        B = torch.stack([b, 2 * b], 1)
        res, ref = api.solve(csr, B), cg_solve_multi(csr, B.cpu())
    assert res.x.device.type == "cuda"
    its = lambda r: torch.as_tensor(r.iterations).cpu().numpy()
    np.testing.assert_array_equal(its(res), its(ref))
    assert float((res.x.cpu() - ref.x).abs().max()) <= 1e-10


@pytest.mark.parametrize("fmt", ["csr", "ell"])
def test_kernel_operator_runs_kernel_4_on_the_card(cuda, fmt):
    from conjugategradient_tpu_torch.core import formats as F
    from conjugategradient_tpu_torch.core import oracle

    A = generators.banded_sin_matrix(8192, 160)
    csr = F.dia_to_csr(A)
    op = cuda_dia.make_kernel_operator(csr if fmt == "csr" else F.csr_to_ell(csr), device=cuda)
    x = np.random.default_rng(5).standard_normal(A.n)
    cuda_dia.reset_launch_counts()
    y = op(torch.from_numpy(x).to(cuda))
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches == 1
    ref = oracle.spmv(A, x)
    assert np.abs(y.cpu().numpy() - ref).max() <= 1e-12 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the chunked driver: one CUDA graph per masked chunk
# ---------------------------------------------------------------------------


def _poisson_mgcg_63(cuda):
    """63^3 Poisson fp32 MGCG on the card: (operator, b, policy, M)."""
    grid = (63, 63, 63)
    s = generators.poisson_system(grid, dtype=np.float32)
    h = build_hierarchy(s.A, grid, smoother="chebyshev", pre=2, post=2, dtype=np.float32,
                        coarse_operator=generators.poisson_coarse_operator(np.float32), device=cuda)
    b = torch.from_numpy(s.b).to(cuda).reshape(grid)
    return h.levels[0].A, b, ConvergencePolicy(tol=1e-6, norm="rel_l2"), as_preconditioner(h)


@pytest.mark.parametrize("chunk", [1, 3, 200])
def test_graph_chunk_matches_eager_mgcg_bitwise(cuda, chunk):
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_chunked

    A, b, pol, M = _poisson_mgcg_63(cuda)
    ref = cg_solve(A, b, policy=pol, M=M, precise_dot=True)
    stats = {}
    got = cg_solve_chunked(A, b, policy=pol, M=M, precise_dot=True, chunk=chunk, stats=stats)
    assert ref.converged and got.converged
    assert got.iterations == ref.iterations
    assert torch.equal(got.x, ref.x)
    assert stats["chunks"] == -(-ref.iterations // chunk)  # one replay and one host read each
    assert stats["capture_s"] > 0


def test_graph_launches_per_chunk_times_replays_equal_eager(cuda):
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_chunked

    A, b, pol, M = _poisson_mgcg_63(cuda)
    cg_solve(A, b, policy=pol, M=M)  # builds and warms everything once
    cuda_stencil.reset_launch_counts()
    cuda_dia.reset_launch_counts()
    ref = cg_solve(A, b, policy=pol, M=M)
    eager = cuda_dia.launch_counts()
    cuda_stencil.reset_launch_counts()
    cuda_dia.reset_launch_counts()
    stats = {}
    got = cg_solve_chunked(A, b, policy=pol, M=M, chunk=1, stats=stats)
    counted = cuda_dia.launch_counts()
    per, warm = stats["launches_per_chunk"], stats["warmup_launches"]
    assert got.iterations == ref.iterations == stats["chunks"]
    assert per == warm and per  # one masked step each
    on_card = {k: v + per.get(k, 0) * (stats["chunks"] - 1) - warm.get(k, 0)
               for k, v in counted.items()}
    assert on_card == eager


def test_graph_capture_over_cusparse_csr(cuda):
    from conjugategradient_tpu_torch.core.formats import dia_to_csr
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_chunked

    s = generators.banded_sin_system(4096, 32)
    A = dia_to_csr(s.A).device_put(device=cuda)
    b, x0 = torch.from_numpy(s.b).to(cuda), torch.from_numpy(s.x0).to(cuda)
    pol = ConvergencePolicy(tol=1e-8)
    ref = cg_solve(A, b, x0, pol)
    got = cg_solve_chunked(A, b, x0, pol, chunk=16)
    assert got.converged and got.iterations == ref.iterations
    assert torch.equal(got.x, ref.x)


def test_graph_capture_failure_raises(cuda):
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_chunked

    A, b, pol, _ = _poisson_mgcg_63(cuda)
    syncing = lambda r: r * float(r.abs().max() > 0)  # a host read inside the step
    with pytest.raises(RuntimeError, match="capturing the masked chunk as a CUDA graph failed"):
        cg_solve_chunked(A, b, policy=pol, M=syncing, chunk=2)
    assert torch.cuda.current_stream(cuda) == torch.cuda.default_stream(cuda)
    assert float(torch.ones(3, device=cuda).sum()) == 3.0  # the card still works


def _amg_poisson(grid, permuted):
    from conjugategradient_tpu_torch.core.io import from_scipy, to_scipy

    s = generators.poisson_system(grid)
    S = to_scipy(s.A)
    if permuted:
        perm = np.random.default_rng(3).permutation(s.n)
        return from_scipy(S[perm][:, perm]), s.b[perm]
    return from_scipy(S), s.b


@pytest.mark.parametrize("permuted", [False, True], ids=["cubes", "greedy"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_amg_cycle_on_card_matches_cpu(cuda, dtype, permuted):
    """One AMG cycle at 31^3 (cube levels on #1/#3, or greedy CSR levels)
    on the card against the same hierarchy's CPU twin; in fp64 the
    amg_cg iteration counts are equal too."""
    from conjugategradient_tpu_torch import api
    from conjugategradient_tpu_torch.precond.amg import amg_vcycle, build_amg_hierarchy

    A, b = _amg_poisson((31, 31, 31), permuted)
    h_cpu = build_amg_hierarchy(A, dtype=dtype, device="cpu")
    h_gpu = build_amg_hierarchy(A, dtype=dtype, device=cuda)
    r = torch.from_numpy(np.asarray(b, dtype))
    ref = amg_vcycle(h_cpu, r)
    out = amg_vcycle(h_gpu, r.to(cuda)).cpu()
    rel = 1e-5 if dtype == np.float32 else 1e-12
    assert float((out - ref).abs().max()) <= rel * float(ref.abs().max())
    if dtype == np.float64:
        kw = dict(method="amg_cg", tol=1e-8, norm="rel_l2", dtype=dtype)
        g, c = api.solve(A, b, device=cuda, **kw), api.solve(A, b, device="cpu", **kw)
        assert g.converged and g.iterations == c.iterations


def test_amg_greedy_restrict_is_deterministic(cuda):
    """The greedy levels' restriction is a fixed-order segment sum: two
    cycles on the card give the same bits."""
    from conjugategradient_tpu_torch.precond.amg import amg_vcycle, build_amg_hierarchy

    A, b = _amg_poisson((31, 31, 31), True)
    h = build_amg_hierarchy(A, dtype=np.float32, device=cuda)
    assert all(l.agg_rows is not None for l in h.levels)
    r = torch.from_numpy(np.asarray(b, np.float32)).to(cuda)
    assert torch.equal(amg_vcycle(h, r), amg_vcycle(h, r))


def test_block_jacobi_apply_without_tf32(cuda):
    """The fp32 apply on the card equals the fp64 one within fp32 rounding
    even with TF32 allowed around it (TF32 keeps about 3 digits)."""
    from conjugategradient_tpu_torch.precond.block_jacobi import block_jacobi_preconditioner

    A = generators.banded_sin_matrix(4099, 16)
    r = np.random.default_rng(5).standard_normal((4099, 3))
    want = block_jacobi_preconditioner(A, 8, dtype=np.float64, device="cpu")(torch.from_numpy(r))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        M = block_jacobi_preconditioner(A, 8, dtype=np.float32, device=cuda)
        for v in (want[:, 0], want):
            got = M(torch.from_numpy(r[:, 0] if v.ndim == 1 else r).float().to(cuda)).double().cpu()
            assert float((got - v).abs().max()) <= 1e-5 * float(v.abs().max())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_aggregation_build_failure_raises_on_the_card(cuda, monkeypatch):
    """No silent fallback to the Python loop where the card runs either."""
    import scipy.sparse as sp

    from conjugategradient_tpu_torch.precond import amg

    monkeypatch.setenv("CXX", "/nonexistent/c++")
    _build.load_host.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="host compiler"):
            amg._aggregate(sp.random(50, 50, density=0.1, format="csr", random_state=0))
    finally:
        _build.load_host.cache_clear()


def _lam1(grid):
    return sum(2.0 - 2.0 * np.cos(np.pi / (g + 1)) for g in grid)


#: the nonsymmetric and indefinite Krylov family at about 63^2 in fp64:
#: route -> (system, api.solve keywords).  Unpreconditioned BiCGStab, IDR
#: and GMRES run on the nonsymmetric band: on convection at 63^2 the first
#: two's counts move under a one-ulp change of b (on the CPU) and GMRES(32)'s
#: 1459 moved by one between the card and the CPU, so no two summation
#: orders could be held to one count there.
KRYLOV_CARD = {
    "bicgstab band": ("band", dict(method="bicgstab")),
    "gmres band restart 8": ("band", dict(method="gmres", restart=8)),
    "fgmres inner bicgstab band": ("band", dict(method="fgmres", inner="bicgstab")),
    "minres helmholtz 63^2": ("helmholtz", dict(method="minres")),
    "idr band": ("band", dict(method="idr")),
    "chebyshev poisson 63^2": ("poisson", dict(method="chebyshev")),
    "mg_bicgstab cd 63^2": ("cd", dict(method="mg_bicgstab", grid=(63, 63))),
    "amg_bicgstab cd 63^2": ("cd", dict(method="amg_bicgstab")),
    "bicgstab band n x 3": ("band", dict(method="bicgstab")),
    "refined inner bicgstab band": ("band", dict(method="refined", inner="bicgstab",
                                                 device_dtype=np.float64)),
}


def _krylov_system(kind):
    g = (63, 63)
    if kind == "band":
        return generators.nonsymmetric_banded_system(63 * 63, 16)
    if kind == "cd":
        return generators.convection_diffusion_system(g, eps=1.0)
    if kind == "helmholtz":
        return generators.helmholtz_system(g, 1.5 * _lam1(g))
    return generators.poisson_system(g)


def _krylov_dia_launches(route, res):
    """Kernel #4's launches (#5's for the block) that the route's recurrence
    implies, from its result."""
    if route.startswith("refined"):
        return 2 * res.inner_iterations + res.outer_iterations  # an initial residual a pass
    it = res.iterations
    if route.startswith(("bicgstab band", "mg_bicgstab", "amg_bicgstab")) and "n x" not in route:
        return 2 * it + 1  # two products an iteration, the initial residual
    if route.startswith("gmres"):
        return 1 + it + 2 * res.cycles  # per cycle its residual and the true one
    if route.startswith("fgmres"):
        return 1 + 2 * res.cycles + it * (1 + 1 + 2 * 8)  # + the 8-step inner BiCGStab
    if route.startswith("minres"):
        return it + 2
    if route.startswith("idr"):
        return 1 + it + res.replacements  # on schedule and at the exit
    if route.startswith("chebyshev"):
        return it + 1
    return (2 * int(res.iterations.max()) + 1) * len(cuda_dia.k_chunks(3))  # the block


@pytest.mark.parametrize("route", sorted(KRYLOV_CARD))
def test_krylov_on_card_matches_cpu_and_launches(cuda, route):
    """fp64 on the card and on the CPU: equal counts, x within 1e-9 of
    ||x||, and kernel #4 (#5 for the block) launched exactly as the
    recurrence implies; a V-cycle's stencil levels launch their kernels."""
    kind, kw = KRYLOV_CARD[route]
    s = _krylov_system(kind)
    b = s.b if "n x" not in route else np.column_stack(
        [s.b] + [np.random.default_rng(j).standard_normal(s.n) for j in (1, 2)])
    opts = dict(tol=1e-8 if kw["method"] == "refined" else 1e-10,
                norm="l2" if kw["method"] == "refined" else "rel_l2", **kw)
    cpu = api.solve(s.A, b, device="cpu", **opts)
    torch.cuda.synchronize()
    cuda_dia.reset_launch_counts()
    cuda_stencil.reset_launch_counts()
    card = api.solve(s.A, b, device=cuda, **opts)
    torch.cuda.synchronize()
    n4, n5 = spmv_dia_cuda.launches, spmm_dia_cuda.launches
    if kw["method"] == "refined":
        assert card.converged and cpu.converged
        assert (card.outer_iterations, card.inner_iterations) == (cpu.outer_iterations,
                                                                  cpu.inner_iterations)
        x_card, x_cpu = card.x, cpu.x
    else:
        assert bool(np.all(_host(card.converged))) and bool(np.all(_host(cpu.converged)))
        np.testing.assert_array_equal(_host(card.iterations), _host(cpu.iterations))
        x_card, x_cpu = _host(card.x), _host(cpu.x)
    assert np.linalg.norm(x_card - x_cpu) <= 1e-9 * np.linalg.norm(x_cpu)
    want = _krylov_dia_launches(route, card)
    assert (n5 if "n x" in route else n4) == want, (n4, n5, want)
    if kw["method"] == "mg_bicgstab":
        assert spmv_stencil_cuda.launches > 0  # the variable-coefficient levels


def _host(v):
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


def test_auto_probe_runs_on_the_card(cuda):
    """``auto``'s second Lanczos stage on the card: the 255^2 Helmholtz at
    1.5 lambda_1 is indefinite (MINRES), at 0.5 lambda_1 SPD (CG); a
    container already on the card is probed the same."""
    g = (255, 255)
    A = generators.helmholtz_matrix(g, 1.5 * _lam1(g))
    assert api._auto_method(A, None, cuda) == "minres"
    assert api._auto_method(A.device_put(device=cuda), None, cuda) == "minres"
    assert api._auto_method(generators.helmholtz_matrix(g, 0.5 * _lam1(g)), None, cuda) == "cg"


# -- least squares, s-step CG, deflation, adjoints ---------------------------


@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
@pytest.mark.parametrize("n, band", [(5000, 160), (4096, 602)])
def test_transposed_dia_matches_twin(cuda, n, band, legs):
    """A^T of a nonsymmetric band (its host transpose: negated offsets,
    ascending) on #4 against the twin, up to and past 256 diagonals (601
    at band 602: the chained split launches at 4096 rows)."""
    from conjugategradient_tpu_torch.core.formats import transpose
    from conjugategradient_tpu_torch.solvers.diff import dia_transpose_traced

    A = generators.nonsymmetric_banded_matrix(n, band)
    At = transpose(A).device_put(legs, cuda)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(n)).to(cuda, legs)
    cuda_dia.reset_launch_counts()
    y = spmv_dia_cuda(At, x)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches == len(cuda_dia.dia_plan(n, At.ndiags).groups)
    ref = spmv_dia_ref(At, x)
    rel = REL64 if legs == torch.float64 else REL
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())
    # the device transpose of the adjoint solve equals the host one
    dT = dia_transpose_traced(torch.from_numpy(A.data).to(cuda), A.offsets, n)
    order = np.argsort([-o for o in A.offsets], kind="stable")
    assert np.array_equal(dT.cpu().numpy()[order], transpose(A).data)


def test_fp64_galerkin_products_on_the_card_match_the_cpu(cuda):
    """make_deflation's AW: W's columns through #4's fp64 instantiation on
    the card against the CPU twin, and E from it."""
    from conjugategradient_tpu_torch.solvers.deflation import galerkin_products

    s = generators.outlier_system(4096, band=16)
    W = torch.from_numpy(np.random.default_rng(5).standard_normal((s.n, 8)).astype(np.float32))
    cuda_dia.reset_launch_counts()
    AW_g, E_g = galerkin_products(s.A, W.to(cuda), device=cuda)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches_by_dtype["fp64"] == 8
    AW_c, E_c = galerkin_products(s.A, W, device="cpu")
    assert float((AW_g.cpu() - AW_c).abs().max()) <= REL64 * float(AW_c.abs().max())
    assert np.abs(E_g - E_c).max() <= 1e-12 * np.abs(E_c).max()


#: route -> (system, api.solve keywords) held card against CPU in fp64
LSQ_ROUTES = {
    "cgnr": ("band", dict(method="cgnr")),
    "lsmr": ("band", dict(method="lsmr")),
    "lsmr damped": ("band", dict(method="lsmr", damp=0.5)),
    "cacg": ("poisson", dict(method="cacg", s=4)),
    "jacobi_cacg": ("banded", dict(method="jacobi_cacg", s=4)),
    "deflated_cg": ("outlier", dict(method="deflated_cg")),
    "refined deflated": ("outlier", dict(method="refined", device_dtype=np.float64)),
}


@pytest.mark.parametrize("route", sorted(LSQ_ROUTES))
def test_least_squares_routes_on_card_match_cpu(cuda, route):
    """fp64 at small size: equal counts, x within 1e-9 ||x||; a deflation
    built on the CPU and moved to the card (the same basis on both)."""
    from conjugategradient_tpu_torch.solvers.deflation import make_deflation

    kind, kw = LSQ_ROUTES[route]
    s = {"band": lambda: generators.nonsymmetric_banded_system(4096, 16),
         "banded": lambda: generators.banded_sin_system(4096, 16),
         "outlier": lambda: generators.outlier_system(4096, band=16),
         "poisson": lambda: generators.poisson_system((63, 63))}[kind]()
    refined = kw["method"] == "refined"
    opts = dict(tol=1e-8 if refined else 1e-10, norm="l2" if refined else "rel_l2", **kw)
    extra = {"cpu": {}, "cuda": {}}
    if kind == "outlier":
        d = make_deflation(s.A, k=4, m=32, dtype=np.float64, device="cpu")
        extra = {"cpu": dict(deflation=d), "cuda": dict(deflation=d.to(cuda))}
    cpu = api.solve(s.A, s.b, device="cpu", **opts, **extra["cpu"])
    cuda_dia.reset_launch_counts()
    card = api.solve(s.A, s.b, device=cuda, **opts, **extra["cuda"])
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches > 0
    if refined:
        assert card.converged and cpu.converged
        assert (card.outer_iterations, card.inner_iterations) == (cpu.outer_iterations,
                                                                  cpu.inner_iterations)
        x_card, x_cpu = card.x, cpu.x
    else:
        assert card.converged and cpu.converged and card.iterations == cpu.iterations
        x_card, x_cpu = _host(card.x), _host(cpu.x)
    assert np.linalg.norm(x_card - x_cpu) <= 1e-9 * np.linalg.norm(x_cpu)


def test_implicit_gradients_on_card_match_cpu(cuda):
    """cg_solve_implicit and bicgstab_solve_implicit in fp64: forward and
    adjoint on #4, gradients against the CPU's."""
    from conjugategradient_tpu_torch.solvers.diff import (
        bicgstab_solve_implicit,
        cg_solve_implicit,
    )
    from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy as P

    for fn, s in ((cg_solve_implicit, generators.banded_sin_system(4096, 16)),
                  (bicgstab_solve_implicit, generators.nonsymmetric_banded_system(4096, 16))):
        grads = {}
        for where in ("cpu", cuda):
            data = torch.from_numpy(s.A.data).to(where).requires_grad_()
            b = torch.from_numpy(s.b).to(where).requires_grad_()
            x = fn(data, b, s.A.offsets, s.A.shape, P(tol=1e-12, norm="rel_l2"))
            torch.sum(torch.sin(x)).backward()
            grads[str(where)] = (_host(data.grad), _host(b.grad))
        (dc, bc), (dg, bg) = grads["cpu"], grads[str(cuda)]
        assert np.abs(dg - dc).max() <= 1e-9 * np.abs(dc).max()
        assert np.abs(bg - bc).max() <= 1e-9 * np.abs(bc).max()


# ---------------------------------------------------------------------------
# the eigensolvers
# ---------------------------------------------------------------------------


def test_lobpcg_and_arnoldi_on_card_match_cpu(cuda):
    """fp64 LOBPCG (a V-cycle M, 31^2 Poisson, k = 4, both from the same
    host draws) and Arnoldi (16^2 convection, LM k = 4) through api.eigs:
    equal counts, values within 1e-10, #5 and #4 launched on the card."""
    from conjugategradient_tpu_torch.solvers.lobpcg import _draw

    A = generators.poisson_system((31, 31)).A
    kw = dict(k=4, which="SM", spd=True, grid=(31, 31), dtype=np.float64,
              X0=_draw(A.n, 4, 0), P0=_draw(A.n, 4, 1))
    cpu = api.eigs(A, device="cpu", **kw)
    cuda_dia.reset_launch_counts()
    card = api.eigs(A, device=cuda, **kw)
    torch.cuda.synchronize()
    assert spmm_dia_cuda.launches == 1 + card.restarts * 2  # k then 3k = 12 columns
    assert card.converged and cpu.converged and card.restarts == cpu.restarts
    assert np.max(np.abs(card.values - cpu.values) / np.abs(cpu.values)) <= 1e-10
    A = generators.convection_diffusion_matrix((16, 16), eps=0.1)
    cpu = api.eigs(A, k=4, tol=1e-10, device="cpu")
    cuda_dia.reset_launch_counts()
    card = api.eigs(A, k=4, tol=1e-10, device=cuda)
    torch.cuda.synchronize()
    assert spmv_dia_cuda.launches == card.matvecs
    assert card.converged and (card.matvecs, card.restarts) == (cpu.matvecs, cpu.restarts)
    assert np.max(np.abs(card.values - cpu.values) / np.abs(cpu.values)) <= 1e-10


@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
def test_lobpcg_block_pass_on_kernel5(cuda, legs):
    """LOBPCG's A pass: kernel #5 on 3k = 24 rows of a 127^2 Poisson DIA
    (three launches of 8 columns) against its twin."""
    A = generators.poisson_system((127, 127)).A.device_put(legs, cuda)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((24, A.n))).to(cuda, legs)
    cuda_dia.reset_launch_counts()
    Y = spmm_dia_cuda(A, X)
    torch.cuda.synchronize()
    assert spmm_dia_cuda.launches == 3
    ref = spmm_dia_ref(A, X)
    rel = REL64 if legs == torch.float64 else REL
    assert float((Y - ref).abs().max()) <= rel * float(ref.abs().max())


def test_lobpcg_keeps_tf32_off(cuda, monkeypatch):
    """With TF32 allowed globally, an fp32 LOBPCG's Gram, whitening and
    Rayleigh-Ritz products still run in full fp32 (``no_tf32``): with a
    V-cycle M (13 iterations on the CPU) its vectors stay orthonormal to
    1e-5 and its residual reaches 1e-5.  The same run with the pin taken
    out (TF32 on those products) misses one or the other, so the check
    sees TF32; the global setting comes back."""
    import contextlib
    import sys

    import conjugategradient_tpu_torch.solvers.lobpcg  # noqa: F401

    lob = sys.modules["conjugategradient_tpu_torch.solvers.lobpcg"]

    A = generators.poisson_system((63, 63)).A
    M = as_multi_preconditioner(build_hierarchy(A, (63, 63), dtype=np.float32, device=cuda))

    def run():
        r = lob.lobpcg(A, 4, M=M, tol=1e-5, max_iterations=200, device=cuda)
        X = r.eigenvectors.double()
        return r, float((X.T @ X - torch.eye(4, dtype=torch.float64, device=cuda)).abs().max())

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pinned, orth = run()
        assert torch.backends.cuda.matmul.allow_tf32
        monkeypatch.setattr(lob, "no_tf32", contextlib.nullcontext)
        unpinned, orth_tf32 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert pinned.converged and orth <= 1e-5
    assert not unpinned.converged or orth_tf32 > 1e-4, (unpinned.iterations, orth_tf32)


# -- batched kernel #4 (k members of one sparsity); the host kit ------------

BATCHED_CASES = ["banded", "ragged", "poisson3d", "band 300", "16^3 x 343", "16^3 x 1331"]


def _batched_members(case, k, dtype, device):
    """k members of one sparsity: a case's legs times (1 + 0.1 j), stacked
    (k, ndiags, n) on the card, and a (k, n) x."""
    A = _many_diagonals(case) if case in SPLIT_CASES else _dia(case, torch.float64)
    base = torch.as_tensor(A.data, dtype=torch.float64).cpu()
    data = torch.stack([base * (1 + 0.1 * j) for j in range(k)]).to(device, dtype).contiguous()
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((k, A.n))).to(device, dtype)
    return data, tuple(A.offsets), x


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", BATCHED_CASES)
def test_batched_dia_kernel_members_equal_the_single_kernel(cuda, case, dtype, k):
    """Member j of the batched #4 (and of its fused p.Ap) is ``spmv_dia_cuda``
    (``spmv_dot_dia_cuda``) on member j bit for bit, past 256 diagonals
    too (the chained and split launches of the single plan), and within
    the single kernel's tolerance of the twin; one launch per group."""
    data, offs, x = _batched_members(case, k, dtype, cuda)
    n = x.shape[1]
    groups = len(cuda_dia.dia_plan(n, len(offs)).groups)
    cuda_dia.reset_launch_counts()
    y = cuda_dia.spmv_dia_batched_cuda(data, offs, x)
    yf, dots = cuda_dia.spmv_dot_dia_batched_cuda(data, offs, x)
    torch.cuda.synchronize()
    assert cuda_dia.spmv_dia_batched_cuda.launches == groups
    assert cuda_dia.spmv_dot_dia_batched_cuda.launches_by_dtype[cuda_dia.TAGS[dtype]] == groups
    assert torch.equal(y, yf) and dots.shape == (k,)
    ref = cuda_dia.spmv_dia_batched_ref(data, offs, x)
    rel = REL64 if dtype == torch.float64 else REL
    assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())
    for j in range(k):
        A = DiaMatrix(data[j], offs, (n, n))
        assert torch.equal(y[j], spmv_dia_cuda(A, x[j]))
        yj, dj = spmv_dot_dia_cuda(A, x[j])
        assert torch.equal(yf[j], yj) and torch.equal(dots[j], dj)


def test_batched_dia_kernel_reads_nothing_outside_and_refuses(cuda):
    """x carved out of a NaN buffer: NaN exactly where the twin has it;
    bf16 legs, mixed dtypes, a shape mismatch and CPU legs raise."""
    data, offs, x = _batched_members("ragged", 3, torch.float32, cuda)
    xc = _in_nan_buffer(x)
    xc[:, 0] = float("nan")
    y = cuda_dia.spmv_dia_batched_cuda(data, offs, xc)
    ref = cuda_dia.spmv_dia_batched_ref(data, offs, xc)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(y), nan) and 0 < int(nan.sum()) < nan.numel()
    with pytest.raises(TypeError, match="no kernel"):
        cuda_dia.spmv_dia_batched_cuda(data.to(torch.bfloat16), offs, x)
    with pytest.raises(TypeError, match="no kernel"):
        cuda_dia.spmv_dia_batched_cuda(data, offs, x.double())
    with pytest.raises(ValueError, match="do not agree"):
        cuda_dia.spmv_dia_batched_cuda(data, offs[1:], x)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_dia.spmv_dia_batched_cuda(data.cpu(), offs, x)


def test_batched_cg_members_equal_single_solves_on_the_card(cuda):
    """``cg_solve_batched`` on the card: each member's count equals
    ``cg_solve`` on that member, one fused batched launch an iteration."""
    from conjugategradient_tpu_torch.solvers.cg import cg_solve_batched

    s = generators.banded_sin_system(4096, 32)
    k = 4
    data = torch.stack([torch.from_numpy(s.A.data) * (1 + 0.1 * j) for j in range(k)])
    data = data.to(cuda, torch.float32).contiguous()
    B = torch.from_numpy(np.stack([s.b] * k)).to(cuda, torch.float32)
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2")
    cuda_dia.reset_launch_counts()
    res = cg_solve_batched(data, s.A.offsets, s.A.shape, B, policy=pol)
    torch.cuda.synchronize()
    its = res.iterations.tolist()
    assert bool(res.converged.all())
    assert cuda_dia.spmv_dot_dia_batched_cuda.launches == max(its)
    assert cuda_dia.spmv_dia_batched_cuda.launches == 1
    for j in range(k):
        single = cg_solve(DiaMatrix(data[j], s.A.offsets, s.A.shape), B[j], policy=pol)
        assert single.iterations == its[j]


def test_native_kit_is_built_on_the_card_machine(cuda):
    """The kit builds where the card is; where its compiler refuses
    ``-fopenmp`` it runs serially and the refusal is kept beside it."""
    from conjugategradient_tpu_torch import native

    assert native.available()
    if native.threads() == 0:
        assert "-fopenmp" in _build.host_library_path("csrkit").with_suffix(".log").read_text()


def _shard_padded(p, i, n_local, halo, num, pad=4096):
    """Shard i's halo-padded p (cyclic neighbours' slabs, as
    ``parallel.halo.HaloDia`` fills it) carved out of a NaN-filled buffer."""
    L = n_local + 2 * halo
    buf = torch.full((L + 2 * pad,), float("nan"), device=p.device, dtype=p.dtype)
    pp = buf[pad:pad + L]
    blocks = p.view(num, n_local)
    pp[:halo] = blocks[(i - 1) % num, -halo:]
    pp[halo:halo + n_local] = blocks[i]
    pp[halo + n_local:] = blocks[(i + 1) % num, :halo]
    return pp


@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
def test_shard_local_dia_kernel_equals_global_rows(cuda, legs):
    """Kernel #4 on each shard's extended DIA (zero halo rows) over a
    NaN-carved padded p: its middle rows equal the global product's rows bit
    for bit (one launch plan, up to 256 diagonals), its halo rows are zero,
    and the fused p.Ap is the shard's rows' dot."""
    from conjugategradient_tpu_torch.parallel.halo import extend_rows

    s = generators.banded_sin_system(4096, 160)
    num, h = 4, s.A.bandwidth
    n_local = s.n // num
    A = s.A.device_put(legs, cuda)
    p = torch.from_numpy(np.random.default_rng(21).standard_normal(s.n)).to(cuda, legs)
    y = cuda_dia.spmv_dia_cuda(A, p)
    for i in range(num):
        rows = slice(i * n_local, (i + 1) * n_local)
        ext = extend_rows(A.data[:, rows], h)
        Ai = DiaMatrix(ext, s.A.offsets, (ext.shape[1],) * 2)
        pp = _shard_padded(p, i, n_local, h, num)
        yi = cuda_dia.spmv_dia_cuda(Ai, pp)
        assert torch.equal(yi[h:h + n_local], y[rows])
        assert not bool(yi[:h].any()) and not bool(yi[h + n_local:].any())
        yd, d = cuda_dia.spmv_dot_dia_cuda(Ai, pp)
        assert torch.equal(yd, yi)
        terms = p[rows].double() * y[rows].double()
        # the fused dot sums in its own order: bounded against sum |terms|
        bound = (REL if legs == torch.float32 else REL64) * float(terms.abs().sum())
        assert abs(float(d) - float(terms.sum())) <= bound


def test_four_shards_on_one_card_take_the_one_shard_count(cuda):
    """``sharded_cg_solve`` with four shards on cuda:0: the 1-shard fp64
    count, x within 1e-10 of it, kernel #4 once per shard per product (the
    initial residual on the plain launch, every iteration on the fused
    one)."""
    from conjugategradient_tpu_torch.parallel import make_mesh, sharded_cg_solve

    s = generators.banded_sin_system(4096, 160)
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2")
    one = sharded_cg_solve(s.A, s.b, s.x0, pol, make_mesh(1, devices=[cuda]))
    cuda_dia.reset_launch_counts()
    four = sharded_cg_solve(s.A, s.b, s.x0, pol, make_mesh(4, devices=[cuda] * 4))
    torch.cuda.synchronize()
    assert one.converged and four.converged and four.iterations == one.iterations
    assert four.x.device == cuda
    assert float((four.x - one.x).abs().max() / one.x.abs().max()) <= 1e-10
    assert cuda_dia.spmv_dia_cuda.launches == 4
    assert cuda_dia.spmv_dot_dia_cuda.launches == 4 * four.iterations


def test_shard_slab_stencil_kernel_equals_global_rows(cuda):
    """Kernel #3 on each shard's extended slab (zero halo grid rows, the
    neighbours' rows filled in, NaN-poisoned buffer halos before the
    exchange): the middle rows equal kernel #3 on the global grid's rows,
    bit for bit on the tuned kernel (a 5-point Poisson level, 4 shards of
    128^2) and within REL of Σ|leg·x| on the wide one (a 21-leg halo-2
    Galerkin level, whose legs may split across threads differently)."""
    from conjugategradient_tpu_torch.parallel import make_mesh
    from conjugategradient_tpu_torch.parallel.halo import HaloStencil
    from conjugategradient_tpu_torch.parallel.mesh import shard_rows

    grid = (128, 128)
    h = build_hierarchy(generators.poisson_system(grid).A, grid, dtype=np.float32, device=cuda,
                        max_coarse=64, const_detect=False)
    m = make_mesh(4, devices=[cuda] * 4)
    rng = np.random.default_rng(23)
    for lvl in h.levels[:2]:
        A = lvl.A
        x = torch.from_numpy(rng.standard_normal(lvl.grid)).to(cuda, torch.float32)
        want = cuda_stencil.spmv_stencil_cuda(A, x)
        op = HaloStencil(shard_rows(m, A.data, dim=1), A.shifts, max(abs(s[0]) for s in A.shifts))
        xs = shard_rows(m, x, dim=0)
        for buf in op._buffers(xs):
            for t in buf.parts:
                t.fill_(float("nan"))
        got = op(xs).gather()
        if cuda_stencil.var_route(A) == "narrow":
            assert torch.equal(got, want)
        else:
            scale = cuda_stencil.spmv_stencil_ref(
                StencilMatrix(A.data.abs(), A.shifts, A.grid), x.abs())
            assert bool(((got - want).abs() <= REL * scale).all())
        assert torch.equal(torch.isfinite(got), torch.ones_like(got, dtype=torch.bool))


def test_shard_dia_block_kernel_equals_twin_and_columns(cuda):
    """Kernel #5 on a shard's extended DIA at k = 4: equal to its twin
    within REL, and each column equal to kernel #4 on that column."""
    from conjugategradient_tpu_torch.parallel.halo import extend_rows

    s = generators.banded_sin_system(4096, 160)
    n_local, hb = s.n // 4, s.A.bandwidth
    A = s.A.device_put(torch.float32, cuda)
    ext = extend_rows(A.data[:, n_local:2 * n_local], hb)
    Ai = DiaMatrix(ext, s.A.offsets, (ext.shape[1],) * 2)
    X = torch.from_numpy(np.random.default_rng(24).standard_normal((4, ext.shape[1]))).to(
        cuda, torch.float32)
    Y = cuda_dia.spmm_dia_cuda(Ai, X)
    ref = cuda_dia.spmm_dia_ref(Ai, X)
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    for j in range(4):
        assert torch.equal(Y[j], cuda_dia.spmv_dia_cuda(Ai, X[j].contiguous()))


def test_four_shard_mgcg_on_the_card_takes_the_cpu_count(cuda):
    """``shard_mgcg_solve`` with four shards on cuda:0 against the same
    solve on four CPU shards, fp64: counts within one, x close, kernel #3
    launched on the card."""
    from conjugategradient_tpu_torch.parallel import make_mesh, shard_mgcg_solve

    grid = (128, 64)
    s = generators.poisson_system(grid)
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=200)
    cpu = shard_mgcg_solve(s, grid, make_mesh(4, devices=["cpu"] * 4), pol,
                           hierarchy=build_hierarchy(s.A, grid, device="cpu", max_coarse=128))
    cuda_stencil.reset_launch_counts()
    card = shard_mgcg_solve(s, grid, make_mesh(4, devices=[cuda] * 4), pol,
                            hierarchy=build_hierarchy(s.A, grid, device=cuda, max_coarse=128))
    torch.cuda.synchronize()
    assert cpu.converged and card.converged and abs(card.iterations - cpu.iterations) <= 1
    assert card.x.device == cuda
    assert float((card.x.cpu() - cpu.x).abs().max() / cpu.x.abs().max()) <= 1e-8
    assert (cuda_stencil.spmv_stencil_cuda.launches
            + cuda_stencil.spmv_stencil_wide_cuda.launches) > 0


@pytest.mark.parametrize("method", ["bicgstab", "idr", "minres", "lsmr", "chebyshev"])
def test_four_shard_nonsym_on_one_card_takes_the_one_shard_count(cuda, method):
    """``parallel.shard_nonsym`` with four shards on cuda:0 against one
    shard, fp64: counts within 2 (IDR: 2 cycles of 5 matvecs), x within
    1e-9 of the 1-shard x, kernel #4 once a shard a product (the count the
    recurrence implies)."""
    from conjugategradient_tpu_torch.parallel import make_mesh
    from conjugategradient_tpu_torch.parallel import shard_nonsym as sn
    from conjugategradient_tpu_torch.solvers.cheby import estimate_bounds

    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=4000)
    if method == "minres":
        s = generators.helmholtz_system((64, 64), shift=0.05)
    elif method == "chebyshev":
        s = generators.poisson_system((64, 64))
    else:
        s = generators.nonsymmetric_banded_system(4096, 16)
    kw = dict(bounds=estimate_bounds(s.A), check_every=4) if method == "chebyshev" else {}
    res = {}
    for num in (1, 4):
        m = make_mesh(num, devices=[cuda] * num)
        cuda_dia.reset_launch_counts()
        if method == "lsmr":
            r = sn.sharded_lsmr_solve(s.A, s.b, policy=pol, mesh=m)
        else:
            r = sn.sharded_nonsym_solve(s.A, s.b, policy=pol, method=method, mesh=m, **kw)
        torch.cuda.synchronize()
        per = {"bicgstab": 1 + 2 * r.iterations, "minres": r.iterations + 2,
               "lsmr": 2 * r.iterations + 3, "chebyshev": r.iterations + 1,
               "idr": 1 + r.iterations + getattr(r, "replacements", 0)}[method]
        assert r.converged and r.x.device == cuda
        assert cuda_dia.spmv_dia_cuda.launches == num * per
        res[num] = r
    assert abs(res[4].iterations - res[1].iterations) <= (10 if method == "idr" else 2)
    assert float((res[4].x - res[1].x).abs().max() / res[1].x.abs().max()) <= 1e-9


@pytest.mark.parametrize("legs", [torch.float32, torch.float64])
def test_extended_region_dia_kernel_equals_global_rows(cuda, legs):
    """The Chebyshev block loop's product: kernel #4 on a shard's DIA
    extended by the neighbours' H = 4 x halo boundary rows
    (``halo.extend_dia_data``) over the vector extended the same way; its
    exact region, the rows at least one bandwidth inside the extension,
    equals kernel #4 on the global rows bit for bit."""
    from conjugategradient_tpu_torch.parallel import make_mesh
    from conjugategradient_tpu_torch.parallel.halo import _square, extend_dia_data
    from conjugategradient_tpu_torch.parallel.mesh import shard_rows

    s = generators.banded_sin_system(4096, 160)
    num, hb = 4, s.A.bandwidth
    n_local, H = s.n // num, 4 * hb
    A = s.A.device_put(legs, cuda)
    p = torch.from_numpy(np.random.default_rng(25).standard_normal(s.n)).to(cuda, legs)
    y = cuda_dia.spmv_dia_cuda(A, p)
    m = make_mesh(num, devices=[cuda] * num)
    ext = extend_dia_data(shard_rows(m, A.data), H)
    for i in (1, 2):  # interior shards: both extensions are real rows
        lo = i * n_local - H
        yi = cuda_dia.spmv_dia_cuda(_square(ext.parts[i], s.A.offsets), p[lo:lo + n_local + 2 * H])
        assert torch.equal(yi[hb:-hb], y[lo + hb:lo + n_local + 2 * H - hb])


def test_probed_hierarchy_on_the_card_equals_the_cpu_build(cuda):
    """``precond.distributed.build_hierarchy_probed`` on four shards of
    cuda:0 against the same build on four CPU shards, fp64: the same level
    grids, transfers and leg sets, legs and ``inv_diag`` within 1e-12, the
    coarse inverse within 1e-10, kernel #3 once a shard per setup product;
    then the masked rung-5 MGCG on both: the same count, the padded plane
    exactly 0."""
    from conjugategradient_tpu_torch.parallel import make_mesh, rung5
    from conjugategradient_tpu_torch.precond.distributed import build_hierarchy_probed

    grid = (62, 40, 48)  # padded to 64 rows of axis 0, 16 a shard
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=200)
    out = {}
    for dev in ("cpu", cuda):
        m = make_mesh(4, devices=[dev] * 4)
        A, b, x0, padded, n_real = rung5.make_rung5_system(grid, m, dtype=np.float64)
        cuda_stencil.reset_launch_counts()
        h = build_hierarchy_probed(A, m, max_coarse=500)
        if dev != "cpu":
            torch.cuda.synchronize()
            launched = (cuda_stencil.spmv_stencil_cuda.launches
                        + cuda_stencil.spmv_stencil_wide_cuda.launches)
            assert launched == sum(shards * n for _, shards, n in h.setup_products)
        res = rung5.make_rung5_mgcg(pol, h)(b, x0)
        out[str(dev)] = (h, res)
    (hc, rc), (hg, rg) = out["cpu"], out[str(cuda)]
    assert len(hg.levels) == len(hc.levels) >= 2
    assert len(hg.tail.levels) == len(hc.tail.levels)
    for Lg, Lc in zip(hg.levels, hc.levels):
        assert (Lg.grid, Lg.kind, Lg.op.shifts) == (Lc.grid, Lc.kind, Lc.op.shifts)
        for mg, mc in zip(Lg.op.mats.parts, Lc.op.mats.parts):
            assert float((mg.data.cpu() - mc.data).abs().max()) <= 1e-12
        assert float((Lg.inv_diag.gather(0).cpu() - Lc.inv_diag.gather(0)).abs().max()) <= 1e-12
    for Lg, Lc in zip(hg.tail.levels, hc.tail.levels):
        assert (Lg.grid, Lg.transfer, Lg.A.shifts) == (Lc.grid, Lc.transfer, Lc.A.shifts)
        assert float((Lg.A.data.cpu() - Lc.A.data).abs().max()) <= 1e-12
    assert float((hg.coarse_inv.cpu() - hc.coarse_inv).abs().max()) <= 1e-10
    assert rc.converged and rg.converged and rg.iterations == rc.iterations
    xg = rg.x.gather().cpu()
    assert bool((xg[grid[0]:] == 0).all())
    assert float((xg - rc.x.gather()).abs().max() / rc.x.gather().abs().max()) <= 1e-9


# -- 2-D block partitions and the mesh eigensolvers ------------------------


def _block_case(case, device):
    """(legs, shifts, grid, dtype) of a 2-D block case: a random 9-point 2-D
    stencil (corners), the 5-point jump operator in fp64 and a random
    27-point 3-D stencil, whose diagonal legs read the corner halos."""
    rng = np.random.default_rng(31)
    if case == "jump 64^2 fp64":
        s = generators.diffusion_system((64, 64), kind="jump")
        st = dia_to_stencil(s.A, (64, 64))
        return torch.from_numpy(st.data).to(device), st.shifts, (64, 64), torch.float64
    grid = (64, 64) if case == "9-point 64^2" else (32, 32, 16)
    shifts = tuple(itertools.product(*[(-1, 0, 1)] * len(grid)))
    legs = rng.standard_normal((len(shifts),) + grid)
    for k, sh in enumerate(shifts):  # structural zeros where the neighbour leaves the grid
        for ax, s_ in enumerate(sh):
            idx = [slice(None)] * (1 + len(grid))
            idx[1 + ax] = 0 if s_ < 0 else -1
            if s_:
                legs[k][tuple(idx[1:])] = 0.0
    return torch.from_numpy(legs).to(device, torch.float32), shifts, grid, torch.float32


@pytest.mark.parametrize("case", ["9-point 64^2", "jump 64^2 fp64", "27-point 32^2 x 16"])
def test_block_2d_stencil_kernel_equals_global_rows(cuda, case):
    """Kernel #3 on each block of a (2, 2) mesh of the card, extended on
    axes 0 and 1 (NaN-poisoned buffer halos before the exchange): each
    local block equals kernel #3 on the global grid's block (bit for bit
    on the tuned kernel, within REL of sum |leg x| on the wide one), and
    each extended block's product its twin within REL (REL64 in fp64)."""
    from conjugategradient_tpu_torch.parallel.halo import HaloStencil
    from conjugategradient_tpu_torch.parallel.mesh import Mesh, shard_blocks

    legs, shifts, grid, dt = _block_case(case, cuda)
    A = StencilMatrix(legs, shifts, grid)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal(grid)).to(cuda, dt)
    want = cuda_stencil.spmv_stencil_cuda(A, x)
    m = Mesh([[cuda] * 2] * 2, ("x", "y"))
    op = HaloStencil(shard_blocks(m, legs, (1, 2)), shifts, (1, 1))
    xs = shard_blocks(m, x, (0, 1))
    for buf in op._buffers(xs):
        for t in buf.parts:
            t.fill_(float("nan"))
    got = op(xs).gather_grid(len(grid))
    rel = REL64 if dt == torch.float64 else REL
    if all(cuda_stencil.var_route(B) == "narrow" for B in (A,) + op.mats.parts):
        assert torch.equal(got, want)
    else:  # the wide kernel may split a point's legs across threads differently
        scale = cuda_stencil.spmv_stencil_ref(StencilMatrix(legs.abs(), shifts, grid), x.abs())
        assert bool(((got - want).abs() <= rel * scale).all())
    for Ab, buf in zip(op.mats.parts, op._bufs[op._last].parts):
        y = cuda_stencil.spmv_stencil_cuda(Ab, buf)
        ref = cuda_stencil.spmv_stencil_ref(Ab, buf)
        assert float((y - ref).abs().max()) <= rel * float(ref.abs().max())


def test_sharded_lobpcg_keeps_tf32_off(cuda, monkeypatch):
    """``gspmd_lobpcg`` on 4 shards of the card with the sharded V-cycle as
    M and TF32 allowed globally: its psum'd Gram and row-norm products run
    in full fp32 (``no_tf32``), so its vectors stay orthonormal to 1e-5
    and its residual reaches 1e-5; with the pin taken out one or the
    other misses."""
    import contextlib
    import sys

    from conjugategradient_tpu_torch.parallel import make_mesh

    import conjugategradient_tpu_torch.solvers.lobpcg  # noqa: F401

    lob = sys.modules["conjugategradient_tpu_torch.solvers.lobpcg"]
    grid = (64, 64)
    A = generators.poisson_system(grid).A
    m = make_mesh(4, devices=[cuda] * 4)
    M = api._eig_vcycle(A, grid, torch.float32, cuda, m)

    def run():
        r = lob.gspmd_lobpcg(A, 4, m, M=M, tol=1e-5, max_iterations=200)
        X = r.eigenvectors.double()
        return r, float((X.T @ X - torch.eye(4, dtype=torch.float64, device=cuda)).abs().max())

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        pinned, orth = run()
        assert torch.backends.cuda.matmul.allow_tf32
        monkeypatch.setattr(lob, "no_tf32", contextlib.nullcontext)
        unpinned, orth_tf32 = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert pinned.converged and orth <= 1e-5
    assert not unpinned.converged or orth_tf32 > 1e-4, (unpinned.iterations, orth_tf32)


def test_multiprocess_mesh_on_the_card_equals_the_one_process_mesh(cuda, tmp_path):
    """The sharded CG (fp64, kernel #4 a shard) on 4 shards of cuda:0 over
    a process group: one NCCL rank in this process, then two ranks x 2
    shards over Gloo through the port's launcher (NCCL refuses two ranks on
    one GPU; Gloo stages the CUDA parts through host buffers).  Both take
    the count and the x of the mesh without a process group, bit for bit."""
    import subprocess
    import sys

    import torch.distributed as dist

    from conjugategradient_tpu_torch.parallel import make_mesh, multihost
    from conjugategradient_tpu_torch.scripts import multiprocess_demo as demo

    workload = "ladder_dense_1k"
    ref = demo.run_cg(make_mesh(4, devices=[cuda] * 4), workload)
    assert ref["ok"]
    multihost.initialize_distributed(f"127.0.0.1:{demo.free_port()}", 1, 0, strict=True)
    try:
        assert dist.get_backend() == "nccl"
        nccl = demo.run_cg(multihost.global_mesh(devices=[cuda] * 4), workload)
    finally:
        dist.destroy_process_group()
    assert nccl["iterations"] == ref["iterations"]
    assert all(torch.equal(a, b) for a, b in zip(nccl["x"], ref["x"]))
    proc = subprocess.run(
        [sys.executable, "-m", "conjugategradient_tpu_torch.scripts.multiprocess_demo",
         "--procs", "2", "--local-devices", "2", "--device", "cuda", "--backend", "gloo",
         "--workload", workload, "--out", str(tmp_path), "--timeout", "300"],
        capture_output=True, text=True, timeout=360)
    assert proc.returncode == 0 and '"verdict": "OK"' in proc.stdout, proc.stderr[-3000:]
    recs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    assert all(r["cg"]["iterations"] == ref["iterations"] for r in recs)
    owned = [p for r in recs for p in r["cg"]["x"]]
    assert len(owned) == 4 and all(torch.equal(a, b) for a, b in zip(owned, ref["x"]))
