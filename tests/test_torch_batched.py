"""Batched solves of the port against the JAX package's ``jax.vmap``, on
the CPU in fp64.

``cg_solve_batched`` and ``bicgstab_solve_batched`` solve k DIA systems of
one sparsity as ``jax.vmap`` of ``cg_solve`` / ``bicgstab_solve`` does:
each member keeps its own count and freezes once converged, so the
per-member iteration counts equal the JAX package's and x agrees to the
solve's tolerance.  ``torch.func.vmap`` over ``cg_solve_implicit`` and
``bicgstab_solve_implicit`` runs through the Functions' vmap rules, forward
(``data`` and ``b`` batched, ``b`` alone, ``data`` alone) and under
``torch.func.vmap(torch.func.grad(loss))``, whose gradients equal
``jax.vmap(jax.grad(loss))`` within GRAD_REL.  The batched kernel #4's twin
equals ``spmv_dia_ref`` / ``spmv_dot_dia_ref`` on every member bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core.formats import DiaMatrix as JDia
from conjugategradient_tpu.solvers import diff as jdiff
from conjugategradient_tpu.solvers.bicgstab import bicgstab_solve as j_bicgstab
from conjugategradient_tpu.solvers.cg import cg_solve as j_cg
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import cuda_dia
from conjugategradient_tpu_torch.solvers import diff
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve, bicgstab_solve_batched
from conjugategradient_tpu_torch.solvers.cg import cg_solve, cg_solve_batched
from conjugategradient_tpu_torch.solvers.multi import cg_solve_multi
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy, NotConvergedError

#: the same fp64 solves and adjoints in both packages: gradients within
#: this fraction of their largest entry
GRAD_REL = 1e-8
#: x of the two packages' batched solves, relative to max |x|: both
#: converged far below it
X_REL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _members(A, k):
    """k members of A's sparsity: data x (1 + 0.1 j), as the JAX test."""
    return np.stack([np.asarray(A.data) * (1 + 0.1 * j) for j in range(k)])


def _jax_vmap(solver, datas, bs, offs, shape, **pol):
    f = jax.jit(jax.vmap(lambda d, b: solver(JDia(d, offs, shape), b, policy=JPolicy(**pol))))
    return f(jnp.asarray(datas), jnp.asarray(bs))


def _held_to_jax(res, jres, datas, bs, offs, shape):
    its = np.asarray(jres.iterations)
    np.testing.assert_array_equal(res.iterations.numpy(), its)
    assert bool(res.converged.all()) and bool(np.asarray(jres.converged).all())
    jx = np.asarray(jres.x)
    assert np.abs(res.x.numpy() - jx).max() <= X_REL * np.abs(jx).max()
    for j in range(len(bs)):
        r = bs[j] - oracle.spmv(DiaMatrix(datas[j], offs, shape), res.x[j].numpy())
        assert np.linalg.norm(r) < 1e-9


def test_cg_solve_batched_equals_jax_vmap():
    """``tests/test_diff.py::test_vmap_batched_solves``'s own case."""
    s = tgen.banded_sin_system(256, 8)
    offs, shape = s.A.offsets, s.A.shape
    k = 5
    datas = _members(s.A, k)
    bs = np.random.default_rng(0).standard_normal((k, s.n))
    pol = dict(tol=1e-11, norm="rel_l2")
    res = cg_solve_batched(torch.from_numpy(datas), offs, shape, torch.from_numpy(bs),
                           policy=ConvergencePolicy(**pol))
    _held_to_jax(res, _jax_vmap(j_cg, datas, bs, offs, shape, **pol), datas, bs, offs, shape)
    # each member is the single-system solve (the same twin products)
    for j in range(k):
        single = cg_solve(DiaMatrix(torch.from_numpy(datas[j]), offs, shape),
                          torch.from_numpy(bs[j]), policy=ConvergencePolicy(**pol))
        assert single.iterations == int(res.iterations[j])


def test_bicgstab_solve_batched_equals_jax_vmap():
    s = tgen.convection_diffusion_system((8, 8), eps=0.3)
    offs, shape = s.A.offsets, s.A.shape
    k = 3
    datas = _members(s.A, k)
    bs = np.random.default_rng(1).standard_normal((k, s.n))
    pol = dict(tol=1e-11, norm="rel_l2")
    res = bicgstab_solve_batched(torch.from_numpy(datas), offs, shape, torch.from_numpy(bs),
                                 policy=ConvergencePolicy(**pol))
    _held_to_jax(res, _jax_vmap(j_bicgstab, datas, bs, offs, shape, **pol), datas, bs, offs,
                 shape)
    single = bicgstab_solve(DiaMatrix(torch.from_numpy(datas[2]), offs, shape),
                            torch.from_numpy(bs[2]), policy=ConvergencePolicy(**pol))
    assert single.iterations == int(res.iterations[2])


@pytest.mark.parametrize("kind", ["cg", "bicgstab"])
@pytest.mark.parametrize("batched", ["data and b", "b", "data"])
def test_vmap_forward_routes(kind, batched):
    """``torch.func.vmap`` of an implicit solve equals the loop of single
    solves; ``b`` alone runs ``cg_solve_multi`` / ``bicgstab_solve_multi``
    (kernel #5's route), anything with ``data`` the batched solvers."""
    s = (tgen.banded_sin_system(64, 8) if kind == "cg"
         else tgen.convection_diffusion_system((6, 7), eps=0.5))
    offs, shape = s.A.offsets, s.A.shape
    fn = diff.cg_solve_implicit if kind == "cg" else diff.bicgstab_solve_implicit
    pol = ConvergencePolicy(tol=1e-12, norm="rel_l2", max_iteration=2000)
    k = 3
    datas = torch.from_numpy(_members(s.A, k))
    bs = torch.from_numpy(np.random.default_rng(2).standard_normal((k, s.n)))
    dims = {"data and b": (0, 0), "b": (None, 0), "data": (0, None)}[batched]
    args = (datas if dims[0] == 0 else datas[0], bs if dims[1] == 0 else bs[0])
    X = torch.func.vmap(lambda d, b: fn(d, b, offs, shape, pol), in_dims=dims)(*args)
    for j in range(k):
        ref = fn(datas[j] if dims[0] == 0 else datas[0], bs[j] if dims[1] == 0 else bs[0],
                 offs, shape, pol)
        assert np.abs((X[j] - ref).numpy()).max() <= X_REL * ref.abs().max().item()
    if batched == "b" and kind == "cg":
        multi = cg_solve_multi(DiaMatrix(datas[0], offs, shape), bs.T.contiguous(), policy=pol)
        assert torch.equal(X, multi.x.T)


@pytest.mark.parametrize("kind", ["cg", "bicgstab"])
def test_vmap_grad_equals_jax(kind):
    """Per-member gradients: ``torch.func.vmap(torch.func.grad(loss))``
    through the implicit solve (the adjoint solves batched through the
    same Function) against ``jax.vmap(jax.grad(loss))``."""
    if kind == "cg":
        s, k = tgen.banded_sin_system(64, 8), 4
        fn, jfn = diff.cg_solve_implicit, jdiff.cg_solve_implicit
        pol = dict(tol=1e-13, norm="rel_l2", max_iteration=2000)
    else:
        s, k = tgen.convection_diffusion_system((8, 8), eps=0.3), 3
        fn, jfn = diff.bicgstab_solve_implicit, jdiff.bicgstab_solve_implicit
        pol = dict(tol=1e-12, norm="rel_l2", max_iteration=4000)
    offs, shape = s.A.offsets, s.A.shape
    rng = np.random.default_rng(3)
    datas = _members(s.A, k)
    bs = rng.standard_normal((k, s.n))
    w = rng.standard_normal(s.n)
    tpol, jpol = ConvergencePolicy(**pol), JPolicy(**pol)
    tw = torch.from_numpy(w)

    def loss(d, b):
        return torch.sum(tw * fn(d, b, offs, shape, tpol) ** 2)

    def jloss(d, b):
        return jnp.sum(w * jfn(d, b, offs, shape, jpol) ** 2)

    gd, gb = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1)))(
        torch.from_numpy(datas), torch.from_numpy(bs))
    jgd, jgb = jax.vmap(jax.grad(jloss, argnums=(0, 1)))(jnp.asarray(datas), jnp.asarray(bs))
    for got, want in ((gd, jgd), (gb, jgb)):
        want = np.asarray(want)
        assert got.shape == want.shape
        assert np.abs(got.numpy() - want).max() <= GRAD_REL * np.abs(want).max()


@pytest.mark.parametrize("ndiags_band", [(512, 16), (96, 300)])
def test_batched_twin_equals_the_single_twin_bit_for_bit(ndiags_band):
    """Member j of the batched twin (and of its fused p.Ap) is
    ``spmv_dia_ref`` (``spmv_dot_dia_ref``) of member j, past 256
    diagonals too; ``dia_transpose_traced`` and the diagonal projection
    take the batch as they take each member."""
    n, band = ndiags_band
    rng = np.random.default_rng(4)
    offs = tuple(range(-(band // 2), band - band // 2))
    k = 3
    data = torch.from_numpy(rng.standard_normal((k, len(offs), n)))
    x = torch.from_numpy(rng.standard_normal((k, n)))
    y = cuda_dia.spmv_dia_batched_cuda(data, offs, x)
    y2, dots = cuda_dia.spmv_dot_dia_batched_cuda(data, offs, x)
    assert torch.equal(y, y2) and dots.shape == (k,)
    for j in range(k):
        A = DiaMatrix(data[j], offs, (n, n))
        assert torch.equal(y[j], cuda_dia.spmv_dia_ref(A, x[j]))
        yj, dj = cuda_dia.spmv_dot_dia_ref(A, x[j])
        assert torch.equal(y2[j], yj) and torch.equal(dots[j], dj)
    dT = diff.dia_transpose_traced(data, offs, n)
    lam = diff._project_onto_diagonals(x, y, offs, n)
    for j in range(k):
        assert torch.equal(dT[j], diff.dia_transpose_traced(data[j], offs, n))
        assert torch.equal(lam[j], diff._project_onto_diagonals(x[j], y[j], offs, n))


def test_batched_solvers_refuse_mismatched_shapes():
    s = tgen.banded_sin_system(32, 4)
    data = torch.from_numpy(_members(s.A, 2))
    B = torch.zeros(2, 32, dtype=torch.float64)
    with pytest.raises(ValueError, match="do not agree"):
        cg_solve_batched(data, s.A.offsets, s.A.shape, B[:1])
    with pytest.raises(ValueError, match="do not agree"):
        bicgstab_solve_batched(data, s.A.offsets[1:], s.A.shape, B)
    with pytest.raises(ValueError, match=r"\(k, ndiags, n\)"):
        cg_solve_batched(data[0], s.A.offsets, s.A.shape, B)
    res = cg_solve_batched(data, s.A.offsets, s.A.shape, B)  # b = 0: x = 0 at once
    assert res.iterations.tolist() == [0, 0] and torch.equal(res.x, B)
    B[1] = 1.0
    capped = cg_solve_batched(data, s.A.offsets, s.A.shape, B,
                              policy=ConvergencePolicy(tol=1e-12, max_iteration=2))
    assert capped.converged.tolist() == [True, False] and capped.iterations.tolist() == [0, 2]
    with pytest.raises(NotConvergedError, match="did not converge"):
        capped.raise_if_diverged()
