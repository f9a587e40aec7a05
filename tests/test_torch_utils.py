"""The port's utils package (residual logs, spy plot, phase timer, profiler
trace, tree persistence) and the ``reference_workloads`` twin against the
JAX package, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.models import WORKLOADS as J_WORKLOADS
from conjugategradient_tpu.solvers.cg import cg_solve as j_cg_solve
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu.utils import reslog as jreslog
from conjugategradient_tpu.utils import spy as jspy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import csr_to_ell, dia_to_csr
from conjugategradient_tpu_torch.precond.multigrid import as_preconditioner, build_hierarchy
from conjugategradient_tpu_torch.scripts import reference_workloads
from conjugategradient_tpu_torch.solvers.cg import cg_solve, cg_solve_traced
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy
from conjugategradient_tpu_torch.utils import (
    CGState,
    PhaseTimer,
    load_pytree,
    load_state,
    profiler_trace,
    reslog,
    save_pytree,
    save_state,
    spy,
)


def _history():
    """A traced solve's history and its initial residual ||b - A x0||_2."""
    s = tgen.banded_sin_system(512, 8)
    res, hist = cg_solve_traced(s.A, torch.from_numpy(s.b), torch.from_numpy(s.x0),
                                ConvergencePolicy(tol=1e-8), num_steps=60)
    return res, hist, float(np.linalg.norm(s.b - oracle.spmv(s.A, s.x0)))


@pytest.mark.parametrize("with_r0", [False, True])
def test_residual_records_match_jax(tmp_path, with_r0):
    res, hist, r0 = _history()
    kw = dict(iterations=res.iterations, r0=r0 if with_r0 else None)
    mine = reslog.records_from_history(hist, **kw)
    theirs = jreslog.records_from_history(hist.numpy(), **kw)
    assert len(mine) == res.iterations > 1
    assert [r.to_json() for r in mine] == [r.to_json() for r in theirs]
    assert (mine[0].rel_l2 == 1.0) is not with_r0
    assert reslog.convergence_rate(mine) == jreslog.convergence_rate(theirs)
    assert 0 < reslog.convergence_rate(mine) < 1
    for ext, mw, jw in (("jsonl", reslog.write_jsonl, jreslog.write_jsonl),
                        ("csv", reslog.write_csv, jreslog.write_csv)):
        a, b = tmp_path / f"port.{ext}", tmp_path / f"jax.{ext}"
        mw(str(a), mine)
        jw(str(b), theirs)
        assert a.read_text() == b.read_text()


@pytest.mark.parametrize("which", ["tridiagonal 100", "poisson2d 31"])
def test_spy_matches_jax(which):
    if which.startswith("tridiagonal"):
        A_t, A_j = tgen.tridiagonal_matrix(100), jgen.tridiagonal_matrix(100)
    else:
        A_t, A_j = tgen.poisson2d_matrix(31), jgen.poisson2d_matrix(31)
    for cells in (10, 16, 48):
        np.testing.assert_array_equal(spy.spy_counts(A_t, cells), jspy.spy_counts(A_j, cells))
        assert spy.spy(A_t, cells) == jspy.spy(A_j, cells)
    # any container, on any device, gives the same grid
    ell = csr_to_ell(dia_to_csr(A_t)).device_put(device="cpu")
    np.testing.assert_array_equal(spy.spy_counts(ell, 16), jspy.spy_counts(A_j, 16))


def test_phase_timer_reports_and_profiler_trace_writes(tmp_path):
    t = PhaseTimer()
    with t.phase("input"):
        x = torch.arange(1000.0)
    with t.phase("solve", sync=lambda: y):
        y = x * 2.0
    rep = t.report(iterations=10)
    assert "input" in rep and "solve" in rep and "10 it" in rep and "us/it" in rep
    assert t["solve"] >= 0 and t.total >= t["solve"]
    assert set(t.as_dict()) == {"input", "solve"}
    with pytest.raises(KeyError):
        t["output"]
    d = tmp_path / "trace"
    with profiler_trace(str(d)):
        (torch.arange(1024.0) * 2.0).sum()
    assert (d / "trace.json").stat().st_size > 0
    with profiler_trace(None):  # no-op
        pass


def test_checkpoint_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    st = CGState(x=rng.standard_normal(16), r=rng.standard_normal(16), p=rng.standard_normal(16),
                 rz=1.5, rr=2.5, rr0=3.5, iteration=7)
    path = str(tmp_path / "cg.npz")
    save_state(path, st)
    got = load_state(path)
    np.testing.assert_array_equal(got.x, st.x)
    assert (got.rz, got.rr, got.rr0, got.iteration, got.n) == (1.5, 2.5, 3.5, 7, 16)
    assert sorted(os.listdir(tmp_path)) == ["cg.npz"]  # no tmp file left


def test_save_load_pytree_hierarchy_and_containers(tmp_path):
    grid = (64, 64)
    s = tgen.poisson_system(grid)
    h = build_hierarchy(s.A, grid, dtype=np.float64, device="cpu")
    p = str(tmp_path / "h.npz")
    save_pytree(p, h)
    h2 = load_pytree(p, device="cpu")
    assert (h2.smoother, h2.pre, h2.post, len(h2.levels)) == (h.smoother, h.pre, h.post, len(h.levels))
    assert [lvl.grid for lvl in h2.levels] == [lvl.grid for lvl in h.levels]
    assert h2.setup_s == h.setup_s
    b = torch.from_numpy(s.b).reshape(grid)
    pol = ConvergencePolicy(tol=1e-8, norm="rel_l2")
    r1 = cg_solve(h.levels[0].A, b, policy=pol, M=as_preconditioner(h))
    r2 = cg_solve(h2.levels[0].A, b, policy=pol, M=as_preconditioner(h2))
    assert r1.converged and r1.iterations == r2.iterations
    assert torch.equal(r1.x, r2.x)
    # a host container keeps numpy arrays; a device one comes back as tensors,
    # bf16 legs included
    csr = dia_to_csr(s.A)
    save_pytree(p, csr)
    got = load_pytree(p)
    assert type(got) is type(csr) and got.shape == csr.shape
    for f in ("data", "indices", "indptr", "row_ids"):
        np.testing.assert_array_equal(getattr(got, f), getattr(csr, f))
    dev = s.A.device_put(torch.bfloat16, "cpu")
    save_pytree(p, dev)
    got = load_pytree(p, device="cpu")
    assert got.data.dtype == torch.bfloat16 and torch.equal(got.data, dev.data)
    assert got.offsets == dev.offsets


def test_reference_workloads_twin_matches_jax_counts(tmp_path, capsys):
    out = tmp_path / "rows.json"
    for name in ("r_prototype", "viennacl_small"):
        rc = reference_workloads.main(["--cpu", "--quick", "--only", name, "--json", str(out)])
        assert rc == 0
        (row,) = json.loads(out.read_text())["rows"]
        assert row["workload"] == name and row["ok"]
        w = J_WORKLOADS[name]
        js = w.build(dtype=np.float64)
        pol = w.policy
        jp = JPolicy(tol=pol.tol, norm=pol.norm, min_iteration=pol.min_iteration,
                     max_iteration=4 * js.n)
        rj = jax.jit(lambda b, x0: j_cg_solve(js.A.device_put(), b, x0, jp))(
            jnp.asarray(js.b), jnp.asarray(js.x0))
        assert row["iterations"] == int(rj.iterations) == row["oracle_iterations"]
    assert "ALL OK" in capsys.readouterr().out
