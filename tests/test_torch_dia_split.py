"""The split form of kernels #4 and #5 past 256 diagonals
(``csrc/dia.cu::spmv_dia_kernel_split``, ``spmv_dot_dia_kernel_split``,
``spmm_dia_kernel_split``) emulated on the CPU.

The kernels run only on the card.  ``dia_schedule`` below replays their
launches in torch with the kernels' own decisions, for every thread of
every launch at once: the plan of ``dia_plan`` (one launch per group of
``dia_groups``, S slices of its legs), blocks of ``DIA_SPLIT_LANES`` rows
(``THREADS`` unsplit) by S slices, each thread's slice of the launch's
legs as the kernel computes it (``dia_slices``), a leg skipped where its
neighbour leaves [0, n), slice 0 of a launch after the first starting from
the y the previous launch wrote, the others from 0, and the partials added
in slice order by the slice-0 thread of each row, which writes y once.
The chained SpMM takes the same plan column by column.  The fused p·Ap
reduces each block's rows in the kernel's shuffle tree into one partial,
and one block sums the partials as ``sum_partials_kernel`` does.

x lies between NaNs and y starts as NaN, so a read that the tests should
have skipped, a row not written, or a launch that starts from a y no
earlier launch wrote shows as a NaN.  The emulation repeats the twin's
fp64 operations, grouped by slice, so the two agree to fp64 rounding (1e-12
of the largest |twin| entry), and exactly at S = 1.
"""

import itertools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import cuda_dia
from conjugategradient_tpu_torch.ops.cuda_dia import (
    DIA_SPLIT_LANES,
    DIA_SPLIT_MAX,
    MAX_DIAGS,
    THREADS,
    dia_groups,
    dia_plan,
    dia_slices,
    dia_split,
    dot_partials,
    spmm_dia_ref,
    spmv_dia_ref,
    spmv_dot_dia_ref,
)

#: the emulation repeats the twin's fp64 operations, grouped by slice
REL = 1e-12
_SRC = (Path(cuda_dia.__file__).parents[1] / "csrc" / "dia.cu").read_text()
#: a block gets 48 KB of shared memory without opting in
SMEM_LIMIT = 48 * 1024


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The emulation runs thousands of small torch ops: one intra-op thread
    keeps the suite's parallel workers from oversubscribing the cores (with
    every worker's default threads, a 3 s test ran for minutes)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _define(name):
    return int(re.search(rf"#define {name} (\d+)", _SRC).group(1))


def dia_schedule(A: DiaMatrix, X: torch.Tensor, plan):
    """Y = A X by the launches of ``plan`` on CPU tensors, ``X`` of shape
    (k, n).  Y starts as NaN: a row no launch writes stays NaN."""
    n, k = A.n, X.shape[0]
    pad = max(abs(o) for o in A.offsets) + 1
    nan = torch.full((k, pad), float("nan"), dtype=X.dtype)
    Xp = torch.cat([nan, X, nan], dim=1)
    lanes = DIA_SPLIT_LANES if plan.split > 1 else THREADS
    # every row a thread of the launch takes: block b, lane l -> b * lanes + l
    rows = torch.arange(-(-n // lanes) * lanes)
    live = rows < n
    rc = rows.clamp(max=n - 1)
    Y = torch.full((k, n), float("nan"), dtype=X.dtype)
    for g, (k0, k1, s) in enumerate(plan.groups):
        assert plan.split == 1 or s == min(plan.split, k1 - k0)
        part = []
        for u, (lo, hi) in enumerate(dia_slices(k1 - k0, s)):
            # slice 0 of a launch after the first starts from the y written before
            acc = Y[:, rc].clone() if u == 0 and g > 0 else torch.zeros_like(Y[:, rc])
            for leg in range(k0 + lo, k0 + hi):
                j = rc + A.offsets[leg]
                inside = live & (j >= 0) & (j < n)
                term = A.data[leg, rc] * Xp[:, j + pad]
                acc = torch.where(inside, acc + term, acc)
            part.append(acc)
        total = part[0]
        for u in range(1, s):
            total = total + part[u]
        # the slice-0 thread of each live row writes it once
        Y = total[:, :n].clone()
    return Y


def dot_schedule(y: torch.Tensor, p: torch.Tensor, plan):
    """The fused p·Ap of the last launch: one partial per block of its rows
    (the split kernel's shuffle tree over DIA_SPLIT_LANES lanes; unsplit, the
    tree over THREADS rows), then one block of THREADS threads: strided sums
    of the partials, then a tree.  Returns (partials, dot)."""
    lanes = DIA_SPLIT_LANES if plan.split > 1 else THREADS
    blocks = -(-y.numel() // lanes)
    prod = torch.zeros(blocks * lanes, dtype=y.dtype)
    prod[: y.numel()] = y * p
    v = prod.reshape(blocks, lanes)
    w = lanes // 2
    while w:
        v = torch.cat([v[:, :w] + v[:, w : 2 * w], v[:, w:]], dim=1)  # lanes >= w: unused
        w //= 2
    partial = v[:, 0]
    acc = torch.zeros(THREADS, dtype=y.dtype)
    for b0 in range(0, blocks, THREADS):
        chunk = partial[b0 : b0 + THREADS]
        acc[: chunk.numel()] += chunk
    w = THREADS // 2
    while w:
        acc[:w] += acc[w : 2 * w]
        w //= 2
    return partial, acc[0]


def _stencil_dia(side, h, seed):
    """A random DIA matrix: the (2h + 1)^3 box of a 3-D stencil on side^3
    folded into flat offsets, leg entries whose neighbour leaves [0, n)
    zero (the 16^3 levels of the 128^3 and 256^3 DIA-layout hierarchies
    carry 343 and 1331 diagonals)."""
    n = side ** 3
    box = itertools.product(range(-h, h + 1), repeat=3)
    offs = sorted({(a * side + b) * side + c for a, b, c in box})
    return _dia(offs, n, seed)


def _dia(offs, n, seed):
    data = np.random.default_rng(seed).standard_normal((len(offs), n))
    i = np.arange(n)
    for k, o in enumerate(offs):
        data[k, (i + o < 0) | (i + o >= n)] = 0.0
    return DiaMatrix(torch.from_numpy(data), tuple(int(o) for o in offs), (n, n))


#: the card tests' shapes past 256 diagonals, cut where they would cost the
#: CPU seconds: 16^3 x 343 (the 128^3 DIA MGCG's level), 12^3 x 1331 (the
#: 1331-diagonal box on fewer rows), a band of 300 offsets on 4000 rows
CASES = {
    "16^3 x 343": lambda: _stencil_dia(16, 3, 1),
    "12^3 x 1331": lambda: _stencil_dia(12, 5, 2),
    "band 300 n=4000": lambda: _dia(range(-150, 150), 4000, 3),
}


@pytest.fixture(scope="module")
def cases():
    return {name: make() for name, make in CASES.items()}


def test_split_geometry_and_slices(cases):
    # S = 16 where the rows are few: a slice of a full group keeps 16 legs
    plans = {name: dia_plan(A.n, A.ndiags) for name, A in cases.items()}
    assert {name: p.split for name, p in plans.items()} == {
        "16^3 x 343": 16, "12^3 x 1331": 16, "band 300 n=4000": 16}
    assert plans["16^3 x 343"].groups == ((0, 256, 16), (256, 343, 16))
    assert plans["12^3 x 1331"].groups == tuple((k0, min(k0 + 256, 1331), 16)
                                                for k0 in range(0, 1331, 256))
    assert plans["band 300 n=4000"].groups == ((0, 256, 16), (256, 300, 16))
    # more rows, fewer slices; rows that fill the card alone: unsplit
    assert dia_split(32 ** 3, 343) == 4 and dia_split(64 ** 3, 343) == 1
    assert dia_split(4096, 343, sms=33) == 8
    # a launch never takes more slices than it has legs
    assert dia_plan(4096, 257).groups == ((0, 256, 16), (256, 257, 1))
    # a forced split
    assert dia_plan(4096, 343, split=4).groups == ((0, 256, 4), (256, 343, 4))
    with pytest.raises(ValueError, match="split must be in"):
        dia_plan(4096, 343, split=DIA_SPLIT_MAX + 1)
    for name, A in cases.items():
        p = plans[name]
        assert [(k0, k1) for k0, k1, _ in p.groups] == dia_groups(A.ndiags)  # the chain stays
        for k0, k1, s in p.groups:
            slices = dia_slices(k1 - k0, s)
            assert slices[0][0] == 0 and slices[-1][1] == k1 - k0
            assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))  # in order, no gap
            sizes = [hi - lo for lo, hi in slices]
            assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1  # none empty, balanced
            # a slice of a full group keeps DIA_MIN_SLICE legs
            assert k1 - k0 < MAX_DIAGS or min(sizes) >= cuda_dia.DIA_MIN_SLICE
            # the partials of 4 fp64 columns fit a block's shared memory
            assert s * cuda_dia.CHAINED_K * DIA_SPLIT_LANES * 8 <= SMEM_LIMIT


def test_unsplit_at_most_256_diagonals():
    # the band-160 flagship, HandmadeCL, the DIA MGCG's 7/81/125-diagonal
    # levels and the banded/ragged/poisson3d bit-for-bit cases run the
    # unsplit kernels, whatever their rows
    for n in (1, 31, 4096, 4097, 207_402, 128 ** 3):
        for nd in (1, 7, 81, 125, 159, 256):
            assert dia_split(n, nd) == 1
            assert dia_plan(n, nd) == (1, ((0, nd, 1),))
    assert dia_split(4096, 257) > 1


@pytest.mark.parametrize("split", ["plan", 1, 3])
@pytest.mark.parametrize("name", sorted(CASES))
def test_split_schedule_matches_twin(cases, name, split):
    A = cases[name]
    plan = dia_plan(A.n, A.ndiags, split=None if split == "plan" else split)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((1, A.n)))
    y = dia_schedule(A, x, plan)
    ref = spmv_dia_ref(A, x[0])
    assert not bool(torch.isnan(y).any())  # every row written, nothing outside [0, n) read
    err = float((y[0] - ref).abs().max())
    if plan.split == 1:
        assert err == 0.0  # the twin's order, term by term
    else:
        assert err <= REL * float(ref.abs().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_split_schedule_keeps_the_twins_nans(cases, name):
    # NaNs planted at both ends of x reach exactly the rows whose legs read
    # them, under the plan's split and unsplit
    A = cases[name]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(A.n))
    x[0] = x[-1] = float("nan")
    ref = spmv_dia_ref(A, x)
    nan = torch.isnan(ref)
    assert 0 < int(nan.sum()) < nan.numel()
    for split in (1, dia_split(A.n, A.ndiags)):
        y = dia_schedule(A, x[None], dia_plan(A.n, A.ndiags, split=split))
        assert torch.equal(torch.isnan(y[0]), nan)
        assert float((y[0][~nan] - ref[~nan]).abs().max()) <= REL * float(ref[~nan].abs().max())


@pytest.mark.parametrize("name", sorted(CASES))
def test_chained_spmm_columns_equal_the_spmv(cases, name):
    # the chained SpMM takes #4's plan in column chunks of at most
    # CHAINED_K: column j is the emulated SpMV of column j, exactly
    A = cases[name]
    plan = dia_plan(A.n, A.ndiags)
    X = torch.from_numpy(np.random.default_rng(6).standard_normal((5, A.n)))
    chunks = cuda_dia.spmm_chunks(A, X.shape[0])
    assert chunks == [4, 1]
    Y, c0 = [], 0
    for kc in chunks:
        Y.append(dia_schedule(A, X[c0 : c0 + kc], plan))
        c0 += kc
    Y = torch.cat(Y)
    ref = spmm_dia_ref(A, X)
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    for j in range(X.shape[0]):
        assert torch.equal(Y[j], dia_schedule(A, X[j : j + 1], plan)[0])


@pytest.mark.parametrize("name", sorted(CASES))
def test_fused_dot_partials_from_the_geometry(cases, name):
    A = cases[name]
    p = torch.from_numpy(np.random.default_rng(7).standard_normal(A.n))
    ref_y, ref_dot = spmv_dot_dia_ref(A, p)
    for split in (1, dia_split(A.n, A.ndiags)):
        plan = dia_plan(A.n, A.ndiags, split=split)
        y = dia_schedule(A, p[None], plan)
        partial, dot = dot_schedule(y[0], p, plan)
        # the wrapper's buffer holds exactly the launch's blocks
        assert partial.numel() == dot_partials(A.n, plan.split)
        lanes = _define("DIA_SPLIT_LANES") if split > 1 else _define("THREADS")
        assert partial.numel() == -(-A.n // lanes)
        assert abs(float(dot) - float(ref_dot)) <= REL * float((p * ref_y).abs().sum())


def test_split_constants_match_the_c_source():
    assert _define("MAX_DIAGS") == MAX_DIAGS
    assert _define("THREADS") == THREADS
    assert _define("DIA_SPLIT_LANES") == DIA_SPLIT_LANES
    assert _define("DIA_SPLIT_MAX") == DIA_SPLIT_MAX
    # the kernels' slice bounds are dia_slices'
    assert "lo = (int)((long long)s * nd / S)" in _SRC
    assert "hi = (int)((long long)(s + 1) * nd / S)" in _SRC
    # the blocks: DIA_SPLIT_LANES rows by split slices, a fused p.Ap partial
    # per block, the C entries' limits
    assert "dim3((n + DIA_SPLIT_LANES - 1) / DIA_SPLIT_LANES)" in _SRC
    assert "split > ndiags || split > DIA_SPLIT_MAX" in _SRC
    assert _define("DIA_SPLIT_LANES") * _define("DIA_SPLIT_MAX") <= 1024
