"""The port's row-block partition math (``core.partition``) against the
JAX package's, on the CPU: every function on the same host inputs gives
the same tuples and arrays exactly (integer math and copies only), and
raises where the JAX one raises."""

import numpy as np
import pytest

from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.core import partition as jpart
from conjugategradient_tpu_torch import core
from conjugategradient_tpu_torch.core import formats
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import partition as tpart


def _csr_pair(A):
    c = formats.dia_to_csr(A)
    return c, jformats.CsrMatrix(c.data, c.indices, c.indptr, c.row_ids, c.shape)


def _irregular(n, seed):
    """A CSR with a few long-range entries: windows wider than one shard."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), rng.integers(0, n, n // 4)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), rng.integers(0, n, n // 4)]).astype(np.int32)
    c = formats.coo_to_csr(formats.CooMatrix(rng.normal(size=rows.size), rows, cols, (n, n)))
    return c, jformats.CsrMatrix(c.data, c.indices, c.indptr, c.row_ids, c.shape)


@pytest.mark.parametrize("n,shards", [(97, 4), (64, 8), (5, 8), (1000, 3)])
def test_equal_split_and_halo_ranges_equal_jax(n, shards):
    part, jp = tpart.RowBlockPartition.equal(n, shards), jpart.RowBlockPartition.equal(n, shards)
    assert (part.n, part.num_shards, part.offsets, part.counts, part.uniform) == (
        jp.n, jp.num_shards, jp.offsets, jp.counts, jp.uniform)
    c, cj = _csr_pair(tgen.banded_sin_matrix(n, 6))
    assert tpart.halo_ranges_from_csr(c, part) == jpart.halo_ranges_from_csr(cj, jp)
    c, cj = _irregular(n, n)
    ranges = tpart.halo_ranges_from_csr(c, part)
    assert ranges == jpart.halo_ranges_from_csr(cj, jp)
    if part.uniform:
        assert tpart.halo_hops(c, part) == jpart.halo_hops(cj, jp)
        assert tpart.hops_from_ranges(ranges, part) == jpart.hops_from_ranges(ranges, jp)
    else:
        with pytest.raises(ValueError, match="uniform"):
            tpart.halo_hops(c, part)


@pytest.mark.parametrize("n,multiple", [(1000, 8), (1024, 8), (13, 4), (13, 8)])
def test_pad_and_partition_dia_equal_jax(n, multiple):
    s, sj = tgen.banded_sin_system(n, 8), jgen.banded_sin_system(n, 8)
    (p, n0), (pj, nj) = tpart.pad_system(s, multiple), jpart.pad_system(sj, multiple)
    assert n0 == nj == n and p.A.offsets == pj.A.offsets and p.A.shape == pj.A.shape
    for got, want in ((p.A.data, pj.A.data), (p.b, pj.b), (p.x0, pj.x0)):
        np.testing.assert_array_equal(got, np.asarray(want))
    blocks = tpart.partition_dia(p.A, multiple)
    np.testing.assert_array_equal(blocks, np.asarray(jpart.partition_dia(pj.A, multiple)))
    assert blocks.shape == (multiple, p.A.ndiags, p.A.n // multiple)
    n_local = p.A.n // multiple
    if p.A.bandwidth <= n_local:
        assert tpart.halo_width(p.A, n_local) == jpart.halo_width(pj.A, n_local)
    else:
        with pytest.raises(ValueError, match="exceeds shard size"):
            tpart.halo_width(p.A, n_local)
        with pytest.raises(ValueError, match="exceeds shard size"):
            jpart.halo_width(pj.A, n_local)


def test_refusals_equal_jax():
    A = tgen.banded_sin_matrix(30, 6)
    with pytest.raises(ValueError, match="pad_system first"):
        tpart.partition_dia(A, 4)
    no_diag = formats.DiaMatrix(A.data[:1], A.offsets[:1], A.shape)
    s = tgen.LinearSystem(no_diag, np.ones(30), np.zeros(30))
    with pytest.raises(ValueError, match="no main diagonal"):
        tpart.pad_system(s, 4)
    assert core.RowBlockPartition is tpart.RowBlockPartition
    assert core.partition_dia is tpart.partition_dia
