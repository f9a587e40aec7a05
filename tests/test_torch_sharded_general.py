"""The port's general-sparsity sharded CG (CSR and ELL with exact halos)
against the JAX package's, on the CPU.

Both run on 8-shard meshes (the JAX package's 8 CPU devices, the port's
``make_mesh(8, devices=["cpu"] * 8)``) from the same numpy systems: the hops
from the exact column ranges equal the JAX package's, the shard arrays of
the halo-overlap split equal its bit for bit, and every route (one-hop and
multi-hop rings, the all-gather switch at ``2*hops + 1 >= num``, ELL, a
Jacobi ``M_local``, the communication-reduced variants, 1 to 8 shards)
takes the JAX package's fp64 count with x within X_REL.  The DIA solver's
all-gather fallback (bandwidth past a shard) is held here too.
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu.core import formats as jfmt
from conjugategradient_tpu.core.partition import halo_hops as j_halo_hops
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import sharded_general as jsg
from conjugategradient_tpu.parallel.sharded_cg import sharded_cg_solve as j_sharded
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import formats, oracle
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.partition import RowBlockPartition, halo_hops
from conjugategradient_tpu_torch.parallel import make_mesh
from conjugategradient_tpu_torch.parallel import sharded_general as tsg
from conjugategradient_tpu_torch.parallel.sharded_cg import sharded_cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x|
X_REL = 1e-10
POL = dict(tol=1e-11, norm="rel_l2", max_iteration=4096)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcsr(A):
    """The JAX package's CSR of the same arrays."""
    return jfmt.CsrMatrix(A.data, A.indices, A.indptr, A.row_ids, A.shape)


def _jell(A):
    return jfmt.EllMatrix(A.data, A.cols, A.shape)


def _both(A, s, num=8, jA=None, **kw):
    """(port result, JAX result) of one general solve."""
    jA = jA if jA is not None else (_jell(A) if isinstance(A, formats.EllMatrix) else _jcsr(A))
    r = tsg.sharded_cg_solve_general(A, s.b, s.x0, ConvergencePolicy(**POL),
                                     make_mesh(num, devices=["cpu"] * num), **kw)
    jr = jsg.sharded_cg_solve_general(jA, s.b, s.x0, JPolicy(**POL), j_mesh(num), **kw)
    return r, jr


def _same(r, jr, s):
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    x, xj = r.x.numpy(), np.asarray(jr.x)
    assert np.abs(x - xj).max() <= X_REL * np.abs(xj).max()
    res = s.b - oracle.spmv(s.A, x)
    assert np.linalg.norm(res) / np.linalg.norm(s.b) < 1e-8


def test_hops_from_exact_ranges_equal_jax():
    s = tgen.banded_sin_system(512, 160)  # bandwidth 79
    csr = formats.dia_to_csr(s.A)
    for num, want in ((8, 2), (4, 1)):  # 64 rows a shard reach two shards, 128 one
        part = RowBlockPartition.equal(512, num)
        assert tsg._csr_hops(csr, part) == halo_hops(csr, part) == want
        assert j_halo_hops(_jcsr(csr), part) == want
        assert tsg._ell_hops(formats.csr_to_ell(csr), part) == want
    diag = formats.dia_to_csr(formats.DiaMatrix(np.ones((1, 512)), (0,), (512, 512)))
    assert tsg._csr_hops(diag, RowBlockPartition.equal(512, 8)) == 0


@pytest.mark.parametrize("band", [12, 160])
def test_overlap_split_arrays_bit_equal_jax(band):
    """Every nonzero lands in one of the two sets; both sets equal the JAX
    package's arrays, and the split product is the unsplit one."""
    s = tgen.banded_sin_system(512, band)
    csr = formats.dia_to_csr(s.A)
    part = RowBlockPartition.equal(512, 8)
    hops = halo_hops(csr, part)
    got = tsg._csr_shard_arrays_overlap(csr, part, hops)
    want = jsg._csr_shard_arrays_overlap(_jcsr(csr), part, hops)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    (di, _, _), (db, _, _) = got
    assert int((di != 0).sum() + (db != 0).sum()) == int((csr.data != 0).sum())
    for rebase in (False, True):
        for a, b in zip(tsg._csr_shard_arrays(csr, part, hops, rebase),
                        jsg._csr_shard_arrays(_jcsr(csr), part, hops, rebase)):
            assert np.array_equal(a, b)


def test_csr_one_hop_ring_equals_jax():
    s = tgen.poisson_system((32, 16))
    solve, _ = tsg.make_sharded_cg_general(formats.dia_to_csr(s.A),
                                           make_mesh(8, devices=["cpu"] * 8))
    assert (solve.hops, solve.route) == (1, "ring")
    _same(*_both(formats.dia_to_csr(s.A), s), s)


def test_csr_multihop_ring_equals_jax():
    """bandwidth 159 past 128 rows a shard: two hops, a 5-block ring under 8
    shards."""
    s = tgen.banded_sin_system(1024, 320)
    csr = formats.dia_to_csr(s.A)
    solve, _ = tsg.make_sharded_cg_general(csr, make_mesh(8, devices=["cpu"] * 8))
    assert (solve.hops, solve.route) == (2, "ring")
    _same(*_both(csr, s), s)


def test_csr_allgather_switch_equals_jax():
    """bandwidth 149 on 4 shards of 128 rows: two hops, and a 5-block ring
    would cover the 4 blocks, so the solve gathers (on 8 shards, three hops
    make a 7-block ring)."""
    wide = tgen.banded_sin_system(512, 300)
    csr = formats.dia_to_csr(wide.A)
    solve, _ = tsg.make_sharded_cg_general(csr, make_mesh(8, devices=["cpu"] * 8))
    assert (solve.hops, solve.route) == (3, "ring")
    solve, _ = tsg.make_sharded_cg_general(csr, make_mesh(4, devices=["cpu"] * 4))
    assert (solve.hops, solve.route) == (2, "all-gather")
    _same(*_both(csr, wide, num=4), wide)


def test_ell_equals_jax():
    s = tgen.banded_sin_system(1024, 32)
    _same(*_both(formats.csr_to_ell(formats.dia_to_csr(s.A)), s), s)


def test_csr_jacobi_equals_jax():
    s = tgen.banded_sin_system(1024, 64)
    inv = 1.0 / formats.dia_diagonal(s.A)
    _same(*_both(formats.dia_to_csr(s.A), s, M_local=lambda r, d: d * r, M_aux=inv), s)


@pytest.mark.parametrize("variant", ["cg1", "pipelined"])
def test_general_variants_equal_jax(variant):
    s = tgen.banded_sin_system(512, 12)
    _same(*_both(formats.dia_to_csr(s.A), s, variant=variant), s)


@pytest.mark.parametrize("num", [1, 2, 4, 8])
def test_csr_shard_count_invariance(num):
    s = tgen.banded_sin_system(512, 16)
    r, jr = _both(formats.dia_to_csr(s.A), s, num=num)
    _same(r, jr, s)
    ref = oracle.cg(s.A, s.b, s.x0, tol=1e-11, norm="rel_l2")
    np.testing.assert_allclose(r.x.numpy(), ref.x, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("n, band", [(512, 160), (1536, 160)], ids=["allgather", "halo"])
def test_dia_wide_band_equals_jax(n, band):
    """band 160 (bandwidth 79) on 8 shards: 64 rows a shard take the
    all-gather product, 192 the one-hop halos."""
    s = tgen.banded_sin_system(n, band)
    r = sharded_cg_solve(s.A, s.b, s.x0, ConvergencePolicy(**POL),
                         make_mesh(8, devices=["cpu"] * 8))
    jr = j_sharded(s.A, s.b, s.x0, JPolicy(**POL), j_mesh(8))
    _same(r, jr, s)


def test_general_refuses_what_it_cannot_shard():
    s = tgen.banded_sin_system(100, 6)
    with pytest.raises(ValueError, match="not divisible"):
        tsg.make_sharded_cg_general(formats.dia_to_csr(s.A), make_mesh(8, devices=["cpu"] * 8))
    with pytest.raises(TypeError, match="CsrMatrix or EllMatrix"):
        tsg.make_sharded_cg_general(s.A, make_mesh(4, devices=["cpu"] * 4))
