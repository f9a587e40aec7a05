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
    and 256^3 DIA-layout hierarchies carry 343 and 1331)."""
    rng = np.random.default_rng(len(case))
    if case == "band 300":
        n, offs = 4000, tuple(range(-150, 150))
    else:
        g, h = 16, {"16^3 x 343": 3, "16^3 x 1331": 5}[case]
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
