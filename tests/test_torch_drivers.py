"""The port's traced and chunked CG drivers, checkpoint/resume and the three
parity repairs (``use_pallas`` on the MGCG entry points, the ``(fn,
state)`` preconditioner, the flat transfers) against the JAX package, on
the CPU in fp64, with inputs made from the generators both packages share."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.precond import transfer as jtransfer
from conjugategradient_tpu.solvers.cg import cg_solve_chunked as j_chunked
from conjugategradient_tpu.solvers.cg import cg_solve_traced as j_traced
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu.utils import checkpoint as jckpt
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.precond import transfer
from conjugategradient_tpu_torch.precond.multigrid import (
    as_preconditioner,
    build_hierarchy,
    fmg,
    v_cycle,
)
from conjugategradient_tpu_torch.solvers.cg import cg_solve, cg_solve_chunked, cg_solve_traced
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.utils import checkpoint as ckpt


class Stop(Exception):
    """Simulated process death inside a chunked solve."""


def _banded(n, band):
    sj, st = jgen.banded_sin_system(n, band), tgen.banded_sin_system(n, band)
    np.testing.assert_array_equal(sj.b, st.b)
    np.testing.assert_array_equal(sj.x0, st.x0)
    return sj, st


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float64))


def test_traced_history_and_coefficients_match_jax():
    # the same recurrence in fp64, reductions in another order: rtol 1e-10
    sj, st = _banded(512, 8)
    kw = dict(num_steps=60, with_coefficients=True)
    rj, hj, (aj, bj) = j_traced(sj.A.device_put(), jnp.asarray(sj.b), jnp.asarray(sj.x0),
                                JPolicy(tol=1e-8), **kw)
    rt, ht, (at, bt) = cg_solve_traced(st.A, _t(st.b), _t(st.x0), ConvergencePolicy(tol=1e-8), **kw)
    it = int(rj.iterations)
    assert rt.iterations == it and rt.converged == bool(rj.converged) and 0 < it < 60
    for got, want in ((ht, hj), (at, aj), (bt, bj)):
        assert got.shape == (60,) and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy()[:it], np.asarray(want)[:it], rtol=1e-10)
    # frozen steps: the history's tail is flat at the final residual
    assert bool((ht[it:] == rt.residual).all())
    np.testing.assert_allclose(float(rt.residual), float(rj.residual), rtol=1e-10)
    # the traced solve takes cg_solve's count (num_steps alone bounds it)
    assert cg_solve(st.A, _t(st.b), _t(st.x0), ConvergencePolicy(tol=1e-8)).iterations == it


def test_chunked_matches_cg_solve_bitwise_and_jax():
    sj, st = _banded(1024, 16)
    rj = j_chunked(sj.A.device_put(), jnp.asarray(sj.b), jnp.asarray(sj.x0), JPolicy(tol=1e-8),
                   chunk=7)
    pol = ConvergencePolicy(tol=1e-8)
    plain = cg_solve(st.A, _t(st.b), _t(st.x0), pol)
    stats = {}
    rt = cg_solve_chunked(st.A, _t(st.b), _t(st.x0), pol, chunk=7, stats=stats)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == plain.iterations == int(rj.iterations)
    assert torch.equal(rt.x, plain.x)
    np.testing.assert_allclose(rt.x.numpy(), np.asarray(rj.x), rtol=1e-9)
    assert float(rt.residual) == float(plain.residual)
    # one host read per chunk; no graph on the CPU
    assert stats["chunks"] == -(-rt.iterations // 7) and stats["capture_s"] == 0


@pytest.mark.parametrize("chunk", [20, 50])
def test_chunked_nonconvergence_flag(chunk):
    st = tgen.tridiagonal_system(512)
    res = cg_solve_chunked(st.A, _t(st.b), policy=ConvergencePolicy(tol=1e-30, max_iteration=50),
                           chunk=chunk)
    assert not res.converged
    assert res.iterations == 50  # max_iteration holds inside a chunk


def test_chunked_resume_continues_sequence(tmp_path):
    st = tgen.tridiagonal_system(2048)
    pol = ConvergencePolicy(tol=1e-8, max_iteration=8192)
    path = str(tmp_path / "state.npz")
    seen = []

    def bail(state):
        seen.append(state.iteration)
        if state.iteration >= 200:
            raise Stop

    with pytest.raises(Stop):
        cg_solve_chunked(st.A, _t(st.b), policy=pol, chunk=100, checkpoint_path=path, callback=bail)
    assert seen == [100, 200]
    mid = ckpt.load_state(path)
    assert mid.iteration == 200
    res = cg_solve_chunked(st.A, _t(st.b), policy=pol, chunk=500, checkpoint_path=path)
    assert res.converged and res.iterations > mid.iteration
    # the file carries the exact state: the resumed sequence is the
    # uninterrupted one, bit for bit
    plain = cg_solve(st.A, _t(st.b), policy=pol)
    assert res.iterations == plain.iterations
    assert torch.equal(res.x, plain.x)
    ref = oracle.cg(st.A, st.b, tol=1e-8, max_iteration=8192)
    denom = np.maximum(np.abs(ref.x), 1e-3 * np.abs(ref.x).max())
    assert np.max(np.abs(res.x.numpy() - ref.x) / denom) < 1e-5
    # resume=False starts over
    again = cg_solve_chunked(st.A, _t(st.b), policy=pol, chunk=500, checkpoint_path=path,
                             resume=False)
    assert torch.equal(again.x, plain.x)


def test_checkpoint_state_carries_across_both_ways(tmp_path):
    sj, st = _banded(1024, 16)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")

    def bail(state):
        raise Stop

    A, b, x0 = sj.A.device_put(), jnp.asarray(sj.b), jnp.asarray(sj.x0)
    with pytest.raises(Stop):
        j_chunked(A, b, x0, JPolicy(tol=1e-8), chunk=7, checkpoint_path=jpath, callback=bail)
    full = j_chunked(A, b, x0, JPolicy(tol=1e-8), chunk=7)
    assert jckpt.load_state(jpath).iteration == 7
    # a JAX file, resumed by the port, reaches JAX's count
    res = cg_solve_chunked(st.A, _t(st.b), _t(st.x0), ConvergencePolicy(tol=1e-8), chunk=7,
                           checkpoint_path=jpath)
    assert res.converged and res.iterations == int(full.iterations)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(full.x), rtol=1e-9)
    # a port file, loaded by the JAX package, gives equal fields
    with pytest.raises(Stop):
        cg_solve_chunked(st.A, _t(st.b), _t(st.x0), ConvergencePolicy(tol=1e-8), chunk=7,
                         checkpoint_path=tpath, callback=bail)
    mine, theirs = ckpt.load_state(tpath), jckpt.load_state(tpath)
    for f in ("x", "r", "p"):
        np.testing.assert_array_equal(getattr(theirs, f), getattr(mine, f))
    assert (theirs.rz, theirs.rr, theirs.rr0, theirs.iteration) == (
        mine.rz, mine.rr, mine.rr0, mine.iteration) and mine.iteration == 7


def test_fn_state_preconditioner_is_the_callable_form():
    grid = (31, 31)
    s = tgen.poisson_system(grid)
    h = build_hierarchy(s.A, grid, max_coarse=64, dtype=np.float64, device="cpu")
    assert len(h.levels) == 2
    A, b = h.levels[0].A, _t(s.b).reshape(grid)
    pol = ConvergencePolicy(tol=1e-9, norm="rel_l2")
    pair = (lambda h_, r: v_cycle(h_, r), h)
    ref = cg_solve(A, b, policy=pol, M=as_preconditioner(h))
    assert ref.converged
    for got in (cg_solve(A, b, policy=pol, M=pair),
                cg_solve_chunked(A, b, policy=pol, M=pair, chunk=3),
                cg_solve_chunked(A, b, policy=pol, M=as_preconditioner(h), chunk=3)):
        assert got.iterations == ref.iterations and got.converged
        assert torch.equal(got.x, ref.x)


def test_mgcg_entry_points_take_use_pallas():
    grid = (15, 15)
    s = tgen.poisson_system(grid)
    kw = dict(method="mgcg", grid=grid, tol=1e-8, norm="rel_l2", use_pallas=False)
    rt = api.solve(s.A, s.b, device="cpu", **kw)
    rj = japi.solve(jgen.poisson_system(grid).A, jnp.asarray(s.b), **kw)
    assert rt.converged and bool(rj.converged)
    assert rt.iterations == int(rj.iterations)
    h = build_hierarchy(s.A, grid, max_coarse=16, dtype=np.float64, device="cpu")
    assert len(h.levels) == 2
    b = _t(s.b).reshape(grid)
    assert torch.equal(v_cycle(h, b, use_pallas=False), v_cycle(h, b))
    assert torch.equal(fmg(h, b, use_pallas=False), fmg(h, b))
    assert torch.equal(as_preconditioner(h, use_pallas=False)(b), as_preconditioner(h)(b))


@pytest.mark.parametrize("fine", [(15, 31), (7, 15, 7)])
def test_flat_transfers_match_jax(fine):
    rng = np.random.default_rng(5)
    r = rng.standard_normal(int(np.prod(fine)))
    coarse = transfer.coarse_shape(fine)
    e = rng.standard_normal(int(np.prod(coarse)))
    got_r = transfer.restrict(_t(r), fine)
    got_p = transfer.prolong(_t(e), fine)
    assert got_r.shape == (int(np.prod(coarse)),) and got_p.shape == (r.size,)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(jtransfer.restrict(jnp.asarray(r), fine)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(jtransfer.prolong(jnp.asarray(e), fine)),
                               rtol=1e-12, atol=1e-12)
