"""Default-dtype (fp64), 1-D and tensor-input solves of the port against the
JAX package, on the CPU.

The generators build fp64 systems, and ``api.solve(method="mgcg")`` with
``dtype=None`` keeps that dtype at every level, where the JAX package's XLA
path computes any dtype and rank; on the card those solves launch kernel #1
in fp64 and on 1-D grids, and an fp64 ``(n, k)`` block CG kernel #5 in
fp64.  Here the same seeded systems go through both packages: the
iteration counts must be equal and the solutions agree to 1e-10 relative
(fp64, the same recurrence; only the order of a few sums differs).

The entry points take right-hand sides that are torch tensors as the JAX
package takes device arrays: ``mgcg_solve``, ``refined_solve`` (host and
device residual) and ``refined_solve_multi`` given tensors return exactly
what they return for the same data as numpy.  A CUDA tensor refuses numpy's
``np.asarray`` (``Tensor.__array__`` raises); the fixture ``device_like``
makes every tensor refuse it the same way, so these CPU tests fail where an
entry point would hand a card tensor to numpy.
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import host_f64, place
from conjugategradient_tpu_torch.ops import cuda_dia, cuda_stencil
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy, mgcg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi

#: fp64 solutions of one recurrence in two packages
AGREE = 1e-10


@pytest.fixture
def device_like(monkeypatch):
    """Tensors refuse ``np.asarray`` as a CUDA tensor does."""

    def refuse(self, *args, **kwargs):
        raise TypeError(f"can't convert {self.device} device type tensor to numpy (as cuda:0)")

    monkeypatch.setattr(torch.Tensor, "__array__", refuse)


@pytest.mark.parametrize("grid", [(63, 63), (31, 31, 31), (4095,), (1023,)])
def test_default_dtype_mgcg_matches_jax(grid):
    # (4095,) is above max_coarse = 1025: a 1-D hierarchy of const levels
    js, ts = jgen.poisson_system(grid), tgen.poisson_system(grid)
    assert ts.A.data.dtype == np.float64
    rj = japi.solve(js.A, js.b, method="mgcg", grid=grid, tol=1e-10, norm="rel_l2")
    cuda_stencil.reset_launch_counts()
    rt = api.solve(ts.A, ts.b, method="mgcg", grid=grid, tol=1e-10, norm="rel_l2", device="cpu")
    assert rt.x.dtype == torch.float64 and bool(rt.converged) and bool(rj.converged)
    assert int(rt.iterations) == int(rj.iterations)
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= AGREE * np.abs(xj).max()
    assert cuda_stencil.spmv_const_stencil_cuda.launches == 0  # the CPU runs the twins


def test_one_d_hierarchy_has_const_levels():
    h = build_hierarchy(tgen.poisson_system((4095,)).A, (4095,), device="cpu")
    assert [lvl.grid for lvl in h.levels] == [(4095,), (2047,)]
    for lvl in h.levels:
        assert cuda_stencil.const_view(lvl.grid, lvl.A.shifts).spec == 3
        assert lvl.inv_diag.dtype == torch.float64


@pytest.mark.parametrize("k", [1, 3])
def test_fp64_block_cg_matches_jax(k):
    js, ts = jgen.banded_sin_system(700, 16), tgen.banded_sin_system(700, 16)
    B = np.column_stack([ts.b] + [np.random.default_rng(j).standard_normal(ts.n)
                                  for j in range(k - 1)])
    rj = japi.solve(js.A, B, method="cg", tol=1e-8, norm="rel_l2")
    cuda_dia.reset_launch_counts()
    rt = api.solve(ts.A, B, method="cg", tol=1e-8, norm="rel_l2", device="cpu")
    assert rt.x.dtype == torch.float64 and tuple(rt.x.shape) == B.shape
    assert bool(rt.converged.all())
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= AGREE * np.abs(xj).max()
    assert cuda_dia.spmm_dia_cuda.launches == 0


def test_fp64_block_cg_on_a_poisson_dia_matches_jax():
    grid = (31, 31)
    js, ts = jgen.poisson_system(grid), tgen.poisson_system(grid)
    B = np.column_stack([ts.b, np.linspace(-1.0, 1.0, ts.n), np.ones(ts.n)])
    rj = japi.solve(js.A, B, method="cg", tol=1e-9, norm="rel_l2")
    rt = api.solve(ts.A, B, method="cg", tol=1e-9, norm="rel_l2", device="cpu")
    assert rt.iterations.tolist() == np.asarray(rj.iterations).tolist()
    xj = np.asarray(rj.x)
    assert np.abs(rt.x.numpy() - xj).max() <= AGREE * np.abs(xj).max()


@pytest.mark.parametrize("as_tensor", [torch.from_numpy, lambda a: torch.from_numpy(a).float()])
def test_host_f64_and_place(as_tensor):
    a = np.random.default_rng(1).standard_normal(17)
    t = as_tensor(a)
    h = host_f64(t)
    assert h.dtype == np.float64 and np.array_equal(h, np.asarray(t.double().numpy()))
    assert np.array_equal(host_f64(t.numpy()), h)
    if t.dtype == torch.float64:
        assert np.shares_memory(host_f64(t), t.numpy())  # no copy for a CPU fp64 tensor
    p = place(t, np.float32, "cpu")
    assert p.dtype == torch.float32 and torch.equal(p, place(t.numpy(), torch.float32, "cpu"))
    assert place(t, None, "cpu").dtype == t.dtype


@pytest.mark.parametrize("grid", [(31, 31), (15, 15, 15)])
@pytest.mark.parametrize("with_x0", [False, True])
def test_mgcg_solve_takes_tensors(grid, with_x0, device_like):
    s = tgen.poisson_system(grid)
    x0 = np.random.default_rng(2).standard_normal(s.n) * 1e-2 if with_x0 else None
    h = build_hierarchy(s.A, grid, dtype=np.float32, device="cpu")
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2")
    r_np, _ = mgcg_solve(s.A, s.b, grid, x0=x0, policy=pol, hierarchy=h)
    r_t, _ = mgcg_solve(s.A, torch.from_numpy(s.b), grid,
                        x0=None if x0 is None else torch.from_numpy(x0), policy=pol, hierarchy=h)
    assert r_np.iterations == r_t.iterations and torch.equal(r_np.x, r_t.x)
    # a grid-shaped fp32 tensor lands on the hierarchy's dtype the same way
    r_g, _ = mgcg_solve(s.A, torch.from_numpy(s.b).float().reshape(grid), grid, policy=pol,
                        hierarchy=h)
    r_f, _ = mgcg_solve(s.A, s.b.astype(np.float32), grid, policy=pol, hierarchy=h)
    assert torch.equal(r_g.x, r_f.x)


@pytest.mark.parametrize("device_residual", [False, True])
@pytest.mark.parametrize("grid", [None, (31, 31)])
def test_refined_solve_takes_tensors(device_residual, grid, device_like):
    s = tgen.banded_sin_system(1024, 16) if grid is None else tgen.diffusion_system(grid, contrast=10.0)
    x0 = getattr(s, "x0", None)
    kw = dict(tol=1e-8, norm="l2", grid=grid, device="cpu", device_residual=device_residual)
    a = refined_solve(s.A, s.b, x0, **kw)
    t = refined_solve(s.A, torch.from_numpy(s.b), None if x0 is None else torch.from_numpy(x0), **kw)
    assert a.converged and t.converged
    assert (a.outer_iterations, a.inner_iterations) == (t.outer_iterations, t.inner_iterations)
    assert a.history == t.history and np.array_equal(a.x, t.x)


@pytest.mark.parametrize("grid", [None, (31, 31)])
def test_refined_solve_multi_takes_tensors(grid, device_like):
    s = tgen.banded_sin_system(1024, 16) if grid is None else tgen.diffusion_system(grid, contrast=10.0)
    B = np.column_stack([s.b, np.random.default_rng(3).standard_normal(s.n)])
    X0 = np.full_like(B, 1e-3)
    kw = dict(tol=1e-8, norm="l2", grid=grid, device="cpu")
    a = refined_solve_multi(s.A, B, X0, **kw)
    t = refined_solve_multi(s.A, torch.from_numpy(B), torch.from_numpy(X0), **kw)
    assert bool(a.converged.all()) and np.array_equal(a.converged, t.converged)
    assert np.array_equal(a.inner_iterations, t.inner_iterations) and np.array_equal(a.x, t.x)


def test_api_solve_passes_tensors_through(device_like):
    grid = (31, 31)
    s = tgen.poisson_system(grid)
    for method in ("mgcg", "refined"):
        a = api.solve(s.A, s.b, method=method, grid=grid, tol=1e-8, device="cpu")
        t = api.solve(s.A, torch.from_numpy(s.b), method=method, grid=grid, tol=1e-8, device="cpu")
        xa = a.x.numpy() if torch.is_tensor(a.x) else a.x
        xt = t.x.numpy() if torch.is_tensor(t.x) else t.x
        assert np.array_equal(xa, xt)
