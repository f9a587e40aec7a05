"""The port's mesh, halo exchange and row-block-sharded CG against the JAX
package's, on the CPU.

The JAX side runs on the 8-device CPU mesh that ``tests/conftest.py``
gives it, under ``shard_map``; the port on ``make_mesh(k, devices=["cpu"] *
k)``, k shards of one device (kernel #4's twin for every local product).
Inputs come from the port's numpy generators and both packages get the same
arrays.  The ``halo`` functions that move data equal the JAX ones bit for
bit in fp64, the cyclic wraparound included; those that compute equal the
port's unsharded twin (``spmv_dia_ref`` on the global matrix, the legs
summed in order as numpy sums them) bit for bit and the JAX ones within
JAX_REL: XLA's CPU code sums the same legs in another rounding (a few ulp
from numpy's sequential sum, and from the twin).  ``sharded_cg_solve`` on 1, 2, 4 and 8 shards
takes the JAX package's fp64 counts by every variant (``cacg`` within
CACG_SPREAD, as ``tests/test_torch_cacg.py`` holds the s-step counts) with
x within X_REL; so do Jacobi ``M_local``, every norm, def-CG and a workload
assembled block by block (``make_distributed_system``, bit-equal to the
full build padded); the row generators are bit-identical for every kind.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.parallel import halo as jhalo
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import multihost as jmultihost
from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve as j_sharded
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import DiaMatrix, dia_diagonal
from conjugategradient_tpu_torch.core.partition import pad_system
from conjugategradient_tpu_torch.models import workloads as twl
from conjugategradient_tpu_torch.ops.cuda_dia import spmv_dia_ref
from conjugategradient_tpu_torch.parallel import halo, make_mesh, multihost
from conjugategradient_tpu_torch.parallel.mesh import (
    Shards,
    all_gather,
    pmax,
    ppermute,
    psum,
    shard_rows,
)
from conjugategradient_tpu_torch.parallel.sharded_cg import make_sharded_cg, sharded_cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x|
X_REL = 1e-10
#: s-step counts: within this fraction of the JAX package's
CACG_SPREAD = 0.01
#: a computing halo function against the JAX one: the same legs summed in
#: XLA's rounding, a few ulp apart (9.4e-15 measured)
JAX_REL = 1e-13
VARIANTS = ["cg", "cg1", "pipelined", "cacg"]
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=2000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _meshes(k):
    return make_mesh(k, devices=["cpu"] * k), j_mesh(k)


def _rel(x, xj):
    x, xj = np.asarray(x), np.asarray(xj)
    return float(np.abs(x - xj).max() / np.abs(xj).max())


def _cat(s: Shards, dim=0):
    return torch.cat(list(s.parts), dim=dim).numpy()


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------


def test_mesh_shards_and_collectives():
    m = make_mesh(4, devices=["cpu"] * 4)
    assert m.shape["x"] == 4 and m.size == 4
    with pytest.raises(ValueError, match="requested 5 devices, have 4"):
        make_mesh(5, devices=["cpu"] * 4)
    v = shard_rows(m, np.arange(8.0))
    assert [p.tolist() for p in v.parts] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert [p.tolist() for p in ppermute(v, 1).parts][0] == [6, 7]  # cyclic
    assert [p.tolist() for p in ppermute(v, -1).parts][3] == [0, 1]
    s = psum(Shards.map(lambda t: t.sum(), v))
    assert all(float(p) == 28.0 for p in s.parts)
    assert all(float(p) == 7.0 for p in pmax(Shards.map(lambda t: t.max(), v)).parts)
    assert all(p.tolist() == list(range(8)) for p in all_gather(v).parts)
    assert (2 * v - v + 1).gather().tolist() == list(range(1, 9))
    with pytest.raises(TypeError, match="truth value"):
        bool(v)
    with pytest.raises(ValueError, match="not divisible"):
        shard_rows(m, np.arange(6.0))


# ---------------------------------------------------------------------------
# halo functions, bit for bit against the JAX package under shard_map
# ---------------------------------------------------------------------------

NUM = 8


@pytest.fixture(scope="module")
def band_case():
    """banded_sin(512, 16): bandwidth 8, 64 rows a shard; p and r seeded;
    and band 160 (bandwidth 79 > 64) for the all-gather product."""
    s = tgen.banded_sin_system(512, 16)
    wide = tgen.banded_sin_system(512, 160)
    rng = np.random.default_rng(3)
    return s.A, wide.A, rng.standard_normal(512), rng.standard_normal(512)


def _twin(A, x):
    """The port's unsharded product: kernel #4's twin on the global DIA."""
    return spmv_dia_ref(DiaMatrix(torch.from_numpy(A.data), A.offsets, A.shape),
                        torch.from_numpy(x)).numpy()


#: one jitted JAX program per halo function, shared by its two inputs
_JAX_PROGRAMS = {}


def _jax_run(fn, in_specs, out_specs, *args, key):
    if key not in _JAX_PROGRAMS:
        f = jax.shard_map(fn, mesh=j_mesh(NUM), in_specs=in_specs, out_specs=out_specs)
        _JAX_PROGRAMS[key] = jax.jit(f)
    return _JAX_PROGRAMS[key](*[jnp.asarray(a) for a in args])


HALO_FNS = ["halo_exchange", "exchange_halos", "spmv_dia_local", "spmv_dia_local_overlap",
            "extend_dia_data", "dia_basis_powers", "ring_gather", "spmv_dia_allgather"]


@pytest.mark.parametrize("fn", HALO_FNS)
@pytest.mark.parametrize("constant", [False, True], ids=["seeded", "wraparound"])
def test_halo_functions_against_jax(band_case, fn, constant):
    """``constant``: p = r = 7.3 everywhere, so any wrapped halo value that
    leaked through a structural zero would show at the global ends."""
    A, wide, p, r = band_case
    if constant:
        p = r = np.full(512, 7.3)
    m = make_mesh(NUM, devices=["cpu"] * NUM)
    h, offs, s = A.bandwidth, A.offsets, 4
    data, pt, rt = shard_rows(m, A.data), shard_rows(m, p), shard_rows(m, r)
    vec, mat = P("x"), P(None, "x")
    twin = None  # the unsharded twin's values, where the function computes
    if fn == "halo_exchange":
        got = _cat(halo.halo_exchange(pt, h))
        want = _jax_run(lambda p_: jhalo.halo_exchange(p_, h, "x", NUM), (vec,), vec, p, key=fn)
    elif fn == "exchange_halos":
        left, right = halo.exchange_halos(pt, h)
        got = np.concatenate([_cat(left), _cat(right)])
        jl, jr = _jax_run(lambda p_: jhalo.exchange_halos(p_, h, "x", NUM), (vec,), (vec, vec),
                          p, key=fn)
        want = np.concatenate([np.asarray(jl), np.asarray(jr)])
    elif fn == "spmv_dia_local":
        got = _cat(halo.spmv_dia_local(data, offs, halo.halo_exchange(pt, h), h))
        want = _jax_run(lambda d, p_: jhalo.spmv_dia_local(
            d, offs, jhalo.halo_exchange(p_, h, "x", NUM), h), (mat, vec), vec, A.data, p, key=fn)
        twin = _twin(A, p)
    elif fn == "spmv_dia_local_overlap":
        got = _cat(halo.spmv_dia_local_overlap(data, offs, pt, h))
        want = _jax_run(lambda d, p_: jhalo.spmv_dia_local_overlap(d, offs, p_, h, "x", NUM),
                        (mat, vec), vec, A.data, p, key=fn)
        twin = _twin(A, p)
    elif fn == "extend_dia_data":
        got = _cat(halo.extend_dia_data(data, s * h), dim=1)
        want = _jax_run(lambda d: jhalo.extend_dia_data(d, s * h, "x", NUM), (mat,), mat,
                        A.data, key=fn)
    elif fn == "dia_basis_powers":
        ext = halo.extend_dia_data(data, s * h)
        got = _cat(halo.dia_basis_powers(ext, offs, pt, rt, s, h), dim=1)
        want = _jax_run(lambda d, p_, r_: jhalo.dia_basis_powers(
            jhalo.extend_dia_data(d, s * h, "x", NUM), offs, p_, r_, s, h, "x", NUM),
            (mat, vec, vec), mat, A.data, p, r, key=fn)
        rows = [p] + [p := _twin(A, p) for _ in range(s)] + [r] + [r := _twin(A, r)
                                                                  for _ in range(s - 1)]
        twin = np.stack(rows)
    elif fn == "ring_gather":
        got = _cat(halo.ring_gather(pt, 2))
        want = _jax_run(lambda p_: jhalo.ring_gather(p_, 2, "x", NUM), (vec,), vec, p, key=fn)
    else:
        got = _cat(halo.spmv_dia_allgather(shard_rows(m, wide.data), wide.offsets, pt))
        want = _jax_run(lambda d, p_: jhalo.spmv_dia_allgather(d, wide.offsets, p_, "x", NUM),
                        (mat, vec), vec, wide.data, p, key=fn)
        twin = _twin(wide, p)
    want = np.asarray(want)
    if twin is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got, twin)
        assert np.abs(got - want).max() <= JAX_REL * np.abs(want).max()


@pytest.mark.parametrize("allgather", [False, True])
def test_halo_dia_operator_matches_local_products(band_case, allgather):
    """The solver's operator (persistent padded buffers, fused p.Ap) gives
    ``spmv_dia_local``'s (or the all-gather product's) rows, and a direction
    written into ``fresh()`` is read without a copy."""
    A, wide, p, _ = band_case
    M = wide if allgather else A
    m = make_mesh(NUM, devices=["cpu"] * NUM)
    data, pt = shard_rows(m, M.data), shard_rows(m, p)
    op = halo.HaloDia(data, M.offsets, M.bandwidth, allgather)
    want = _cat(halo.spmv_dia_allgather(data, M.offsets, pt) if allgather else
                halo.spmv_dia_local(data, M.offsets, halo.halo_exchange(pt, M.bandwidth),
                                    M.bandwidth))
    np.testing.assert_array_equal(_cat(op(pt)), want)
    q = op.fresh(pt)
    for dst, src in zip(q.parts, pt.parts):
        dst.copy_(src)
    y, d = op.spmv_dot(q)
    np.testing.assert_array_equal(_cat(y), want)
    assert float(psum(d).parts[0]) == pytest.approx(float(p @ want), rel=1e-13)
    rows = 64 * NUM * (NUM - 1) if allgather else NUM * 2 * M.bandwidth
    assert op.halo_bytes == rows * 8


# ---------------------------------------------------------------------------
# sharded CG against the JAX package
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def system():
    return tgen.banded_sin_system(512, 16)


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("num", [1, 2, 4, 8])
def test_sharded_cg_counts_equal_jax(system, num, variant):
    m, jm = _meshes(num)
    r = sharded_cg_solve(system.A, system.b, system.x0, ConvergencePolicy(**POL), m,
                         variant=variant)
    jr = j_sharded(system.A, system.b, system.x0, JPolicy(**POL), jm, variant=variant)
    assert r.converged and bool(jr.converged)
    if variant == "cacg":
        assert abs(r.iterations - int(jr.iterations)) <= CACG_SPREAD * int(jr.iterations)
        assert 4 * r.outer_steps >= r.iterations  # s = 4 coordinate steps at most per outer step
    else:
        assert r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL
    assert r.x.shape == (512,) and r.residual.ndim == 0


@pytest.mark.parametrize("variant", ["cg", "cg1", "pipelined"])
def test_sharded_jacobi_m_local_equals_jax(variant):
    s = tgen.banded_sin_system(512, 8)
    inv = 1.0 / dia_diagonal(s.A)
    m, jm = _meshes(8)
    r = sharded_cg_solve(s.A, s.b, s.x0, ConvergencePolicy(**POL), m,
                         M_local=lambda r_, d: r_ * d, M_aux=inv, variant=variant)
    jr = j_sharded(s.A, s.b, s.x0, JPolicy(**POL), jm, M_local=lambda r_, d: r_ * d, M_aux=inv,
                   variant=variant)
    assert r.converged and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL
    plain = sharded_cg_solve(s.A, s.b, s.x0, ConvergencePolicy(**POL), m)
    assert r.iterations <= plain.iterations


@pytest.mark.parametrize("norm", ["l2", "linf", "rel_l2"])
def test_sharded_norms_equal_jax(system, norm):
    pol = dict(tol=1e-9, norm=norm, max_iteration=2000)
    m, jm = _meshes(8)
    r = sharded_cg_solve(system.A, system.b, system.x0, ConvergencePolicy(**pol), m)
    jr = j_sharded(system.A, system.b, system.x0, JPolicy(**pol), jm)
    assert r.converged and r.iterations == int(jr.iterations)
    assert float(r.residual) == pytest.approx(float(jr.residual), rel=1e-6)
    res = system.b - oracle.spmv(system.A, r.x.numpy())
    if norm == "linf":
        assert np.abs(res).max() < 1e-9


def test_sharded_divergence_flag_and_padding(system):
    m = make_mesh(4, devices=["cpu"] * 4)
    r = sharded_cg_solve(system.A, system.b, system.x0, ConvergencePolicy(tol=1e-15,
                                                                          max_iteration=3), m)
    assert not r.converged and r.iterations == 3
    raw = tgen.banded_sin_system(100, 6)
    padded, n = pad_system(raw, 8)
    assert padded.n == 104 and n == 100
    r = sharded_cg_solve(padded.A, padded.b, padded.x0,
                         ConvergencePolicy(tol=1e-10, max_iteration=1000),
                         make_mesh(8, devices=["cpu"] * 8))
    ref = oracle.cg(raw.A, raw.b, raw.x0, tol=1e-10, max_iteration=1000)
    np.testing.assert_allclose(r.x.numpy()[:n], ref.x, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(r.x.numpy()[n:], 0.0, atol=1e-12)
    with pytest.raises(ValueError, match="not divisible"):
        sharded_cg_solve(raw.A, raw.b, raw.x0, mesh=make_mesh(8, devices=["cpu"] * 8))
    with pytest.raises(ValueError, match="unpreconditioned"):
        make_sharded_cg(raw.A, make_mesh(2, devices=["cpu"] * 2), variant="cacg",
                        M_local=lambda r_, d: r_)
    with pytest.raises(ValueError, match="unknown CG variant"):
        sharded_cg_solve(padded.A, padded.b, mesh=make_mesh(2, devices=["cpu"] * 2),
                         variant="nope")


def test_sharded_deflated_cg_matches_single_device():
    """Distributed def-CG (fp32, the port's own deflation): the count of
    single-device def-CG within 2, fewer than plain sharded CG; the
    communication-reduced variants refuse the hooks."""
    from conjugategradient_tpu_torch.solvers.deflation import deflated_cg_solve, make_deflation

    s = tgen.outlier_system(1024)
    d = make_deflation(s.A, k=8, m=48, device="cpu")
    pol = ConvergencePolicy(tol=1e-6, norm="rel_l2", max_iteration=2000)
    m = make_mesh(8, devices=["cpu"] * 8)
    r = sharded_cg_solve(s.A, s.b, policy=pol, mesh=m, dtype=np.float32, deflation=d)
    assert r.converged
    res = s.b - oracle.spmv(s.A, r.x.numpy().astype(np.float64))
    assert np.linalg.norm(res) / np.linalg.norm(s.b) < 1e-5
    single = deflated_cg_solve(s.A.device_put(torch.float32, "cpu"),
                               torch.from_numpy(s.b.astype(np.float32)), policy=pol, deflation=d)
    assert abs(r.iterations - single.iterations) <= 2
    plain = sharded_cg_solve(s.A, s.b, policy=pol, mesh=m, dtype=np.float32)
    assert r.iterations < plain.iterations
    with pytest.raises(ValueError, match="variant"):
        sharded_cg_solve(s.A, s.b, mesh=m, dtype=np.float32, deflation=d, variant="cg1")


# ---------------------------------------------------------------------------
# per-block assembly, the multihost helpers, the row generators
# ---------------------------------------------------------------------------


def test_make_distributed_system_per_block_bit_equal():
    """viennacl_large at n = 4099 (not a multiple of 8): each shard's block
    equals ``pad_system`` of the full build and the JAX package's
    assembly bit for bit; the sharded solve on it converges."""
    w = dataclasses.replace(twl.WORKLOADS["viennacl_large"], n=4099)
    import conjugategradient_tpu.models.workloads as jwl

    twl.WORKLOADS["_test_block"] = w
    jwl.WORKLOADS["_test_block"] = dataclasses.replace(jwl.WORKLOADS["viennacl_large"], n=4099)
    try:
        m, jm = _meshes(8)
        A, b, x0, n = multihost.make_distributed_system("_test_block", m)
        jA, jb, jx0, jn = jmultihost.make_distributed_system("_test_block", jm)
    finally:
        del twl.WORKLOADS["_test_block"], jwl.WORKLOADS["_test_block"]
    assert n == jn == 4099 and A.n == 4104 and len(A.data.parts) == 8
    padded, _ = pad_system(w.build(), 8)
    for got, full, jax_arr in ((_cat(A.data, dim=1), padded.A.data, jA.data),
                               (_cat(b), padded.b, jb), (_cat(x0), padded.x0, jx0)):
        assert np.array_equal(got, full) and np.array_equal(got, np.asarray(jax_arr))
    pol = ConvergencePolicy(tol=1e-10, norm="rel_l2", max_iteration=4 * A.n)
    r = make_sharded_cg(A, m, pol)(A.data, b, x0)
    assert r.converged
    res = w.build().b - oracle.spmv(w.build().A, r.x.numpy()[:n])
    assert np.linalg.norm(res) / np.linalg.norm(w.build().b) < 1e-8


def test_multihost_helpers_degrade_to_local():
    import torch.distributed as dist

    from conjugategradient_tpu_torch.scripts.multiprocess_demo import free_port

    multihost.initialize_distributed()  # a no-op for one process
    assert multihost.host_count() == 1 and not dist.is_initialized()
    assert multihost.global_mesh(devices=["cpu"] * 8).shape["x"] == 8
    # an explicit world of one joins a group; a second call is harmless
    try:
        multihost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
        assert dist.is_initialized() and dist.get_backend() == "gloo"
        multihost.initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
        assert multihost.host_count() == 1
        m = multihost.global_mesh(devices=["cpu"] * 4)
        assert m.comm is not None and m.size == 4 and m.owned == range(4)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_initialize_distributed_failures(monkeypatch):
    """strict=True with nothing to join raises; a coordinator no process
    serves re-raises when it was given, and warns and goes on solo when it
    came from torchrun's environment."""
    import torch.distributed as dist

    from conjugategradient_tpu_torch.scripts.multiprocess_demo import free_port

    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="strict=True"):
        multihost.initialize_distributed(strict=True)
    port = free_port()  # nobody listens there: rank 1 cannot reach rank 0
    with pytest.raises(Exception):
        multihost.initialize_distributed(f"127.0.0.1:{port}", 2, 1, timeout=0.5)
    assert not dist.is_initialized()
    for k, v in (("MASTER_ADDR", "127.0.0.1"), ("MASTER_PORT", str(port)), ("WORLD_SIZE", "2"),
                 ("RANK", "1")):
        monkeypatch.setenv(k, v)
    with pytest.warns(UserWarning, match="continuing single-process"):
        multihost.initialize_distributed(timeout=0.5)
    assert not dist.is_initialized() and multihost.host_count() == 1


ROW_CASES = [
    ("banded_sin", dict(band=12), "cos10", "i/100"),
    ("banded_sin", dict(band=6), "one_plus", "zeros"),
    ("banded_sin", dict(band=160), "asin", "i/10"),
    ("tridiagonal", {}, "cos10", "zeros"),
    ("poisson", dict(grid=(300,)), "cos10", "zeros"),
    ("poisson", dict(grid=(15, 20)), "cos10", "zeros"),
    ("poisson", dict(grid=(5, 6, 10)), "cos10", "zeros"),
    ("helmholtz", dict(grid=(15, 20), param=0.3), "cos10", "zeros"),
    ("convection_diffusion", dict(grid=(15, 20)), "cos10", "zeros"),
    ("convection_diffusion", dict(grid=(5, 6, 10), param=0.2), "cos10", "zeros"),
]


@pytest.mark.parametrize("case", ROW_CASES, ids=lambda c: f"{c[0]}-{c[2]}-{c[3]}")
def test_system_rows_bit_identical(case):
    builder, kw, b_kind, x0_kind = case
    got = tgen.system_rows(builder, 37, 211, 300, b_kind=b_kind, x0_kind=x0_kind, **kw)
    want = jgen.system_rows(builder, 37, 211, 300, b_kind=b_kind, x0_kind=x0_kind, **kw)
    assert got[0] == want[0]
    for a, b in zip(got[1:], want[1:]):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for kind in ("cos10", "one_plus", "asin", "i2/2", "poisson"):
        assert np.array_equal(tgen.b_rows(kind, 5, 90, 100, seed=2),
                              jgen.b_rows(kind, 5, 90, 100, seed=2))
    for kind in ("i/100", "i/10", "zeros"):
        assert np.array_equal(tgen.x0_rows(kind, 5, 90), jgen.x0_rows(kind, 5, 90))
    with pytest.raises(ValueError, match="unknown builder"):
        tgen.system_rows("nope", 0, 1, 1)


def test_workload_rows_assemble_the_full_build():
    s = twl.WORKLOADS["viennacl_large"]
    offs, data, b, x0 = s.build_rows(1000, 1400)
    full = s.build()
    assert offs == full.A.offsets
    assert np.array_equal(data, full.A.data[:, 1000:1400])
    assert np.array_equal(b, full.b[1000:1400]) and np.array_equal(x0, full.x0[1000:1400])
    assert isinstance(full.A, DiaMatrix)
