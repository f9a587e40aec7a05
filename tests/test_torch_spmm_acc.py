"""Kernel #6's module on the CPU: the single-call accumulating DIA SpMM.

The twin ``spmm_dia_acc_ref`` (the kernel's group plan and rounding order on
whole arrays) is held to the JAX package's multi-RHS Pallas kernel in
interpret mode and to its XLA ``spmm_dia``, on the same inputs made from a
numpy seed; the group plan to its contract; the experiment module
``scripts/spmm_acc_experiment.py`` to its record on the CPU.  The kernel
itself is compared with the twin on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``); here ``acc_schedule`` replays its launch
block by block (tile, coefficient batches across group boundaries, the two
window buffers, the interior/border split) against the twin in fp64.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.pallas_spmv import spmm_dia_pallas
from conjugategradient_tpu.ops.spmm import spmm_dia as j_spmm_dia
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import card, cuda_dia
from conjugategradient_tpu_torch.ops.cuda_dia import (
    ACC_LMAX,
    ACC_SPAN,
    plan_dia_groups,
    spmm_dia_acc_cuda,
    spmm_dia_acc_ref,
    spmm_dia_ref,
)
from conjugategradient_tpu_torch.scripts import spmm_acc_experiment

N = 4096


def _pair(band, dtype):
    """(JAX DiaMatrix on the device, port DiaMatrix on the CPU) of the same
    banded ``|sin|`` matrix."""
    Aj = jgen.banded_sin_matrix(N, band, dtype=dtype).device_put()
    At = tgen.banded_sin_matrix(N, band, dtype=dtype).device_put(device="cpu")
    return Aj, At


def _X(k, dtype):
    return np.random.default_rng(11).standard_normal((N, k)).astype(dtype)


def _acc(At, X):
    """The twin on an (n, k) block, back in (n, k)."""
    return spmm_dia_acc_ref(At, torch.from_numpy(np.ascontiguousarray(X.T))).numpy().T


@pytest.mark.parametrize("k", [1, 3, 8])
def test_twin_matches_jax_pallas_and_xla_fp32(k):
    Aj, At = _pair(32, np.float32)
    X = _X(k, np.float32)
    Y = _acc(At, X)
    for ref in (np.asarray(spmm_dia_pallas(Aj, jnp.asarray(X), interpret=True)),
                np.asarray(j_spmm_dia(Aj, jnp.asarray(X)))):
        # fp32 sums in other orders: relative 1e-5 of the largest entry
        np.testing.assert_allclose(Y, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("band", [32, 160])
@pytest.mark.parametrize("k", [1, 3, 8])
def test_twin_matches_jax_xla_fp64(band, k):
    # band 160 takes four groups: the partial sums change the rounding order
    Aj, At = _pair(band, np.float64)
    X = _X(k, np.float64)
    ref = np.asarray(j_spmm_dia(Aj, jnp.asarray(X)))
    np.testing.assert_allclose(_acc(At, X), ref, rtol=1e-13, atol=1e-13 * np.abs(ref).max())


def test_wrapper_takes_the_twin_on_the_cpu_and_launches_nothing():
    At = tgen.banded_sin_matrix(N, 160, dtype=np.float32).device_put(device="cpu")
    X = torch.from_numpy(_X(3, np.float32).T.copy())
    n0 = spmm_dia_acc_cuda.launches
    assert torch.equal(spmm_dia_acc_cuda(At, X), spmm_dia_acc_ref(At, X))
    assert spmm_dia_acc_cuda.launches == n0
    # the same product as kernel #5's twin, rounded in another order
    ref = spmm_dia_ref(At, X)
    assert float((spmm_dia_acc_ref(At, X) - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_kernel_path_checks_raise_instead_of_falling_back():
    A = tgen.banded_sin_matrix(333, 8)
    meta = A.device_put(torch.float32, "meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_dia_acc_cuda(meta, torch.empty((2, 333), device="meta"))
    with pytest.raises(ValueError, match="contiguous"):
        spmm_dia_acc_cuda(meta, torch.empty((333, 2), device="meta").T)
    with pytest.raises(TypeError, match="no kernel"):
        spmm_dia_acc_cuda(meta, torch.empty((2, 333), dtype=torch.float64, device="meta"))
    with pytest.raises(TypeError, match="fp32 or bf16"):
        spmm_dia_acc_cuda(A.device_put(torch.float64, "meta"),
                          torch.empty((2, 333), dtype=torch.float64, device="meta"))
    wide = DiaMatrix(np.zeros((300, 400), np.float32), tuple(range(-150, 150)), (400, 400))
    with pytest.raises(ValueError, match="diagonals"):
        spmm_dia_acc_cuda(wide.device_put(device="meta"), torch.empty((2, 400), device="meta"))


PLANS = {
    "band 160": tuple(range(-79, 80)),
    "3-D Poisson 255^3": (-65025, -255, -1, 0, 1, 255, 65025),
    "3-D Poisson 15^3": (-225, -15, -1, 0, 1, 15, 225),
    "no zero offset": (-700, -3, 2, 600),
    "unsorted, wide": (5, -1000, 0, 300, -400, 900, 1, -2, 513, -513),
    "band 255, 254 legs": tuple(o for o in range(-127, 128) if o != 7),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_group_plan_contract(case):
    offsets = PLANS[case]
    groups = plan_dia_groups(offsets)
    legs = [k for g in groups for k in g]
    assert sorted(legs) == list(range(len(offsets)))  # every offset exactly once
    for g in groups:
        offs = [offsets[k] for k in g]
        assert 1 <= len(g) <= ACC_LMAX
        assert offs == sorted(offs) and offs[-1] - offs[0] <= ACC_SPAN
    has_zero = [0 in (offsets[k] for k in g) for g in groups]
    assert has_zero[-1] == (0 in offsets) and sum(has_zero) == (0 in offsets)
    others = [offsets[g[0]] for g, z in zip(groups, has_zero) if not z]
    assert others == sorted(others)  # the rest ascending, as the offsets


def test_group_plan_of_the_two_experiment_shapes():
    assert [len(g) for g in plan_dia_groups(PLANS["band 160"])] == [48, 48, 15, 48]
    offs = PLANS["3-D Poisson 255^3"]
    assert [[offs[k] for k in g] for g in plan_dia_groups(offs)] == [
        [-65025], [65025], [-255, -1, 0, 1, 255]]


def test_experiment_main_on_the_cpu(capsys):
    assert spmm_acc_experiment.main(["--cpu", "--n", "4096", "--band", "32", "--k", "4"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["experiment"] == "spmm_acc_single_call" and rec["platform"] == "cpu"
    assert (rec["n"], rec["k"]) == (4096, 4) and rec["max_rel_err"] < 1e-5
    assert not {"chained_us", "single_call_us", "bound_us"} & set(rec)  # no time off the card


def test_experiment_needs_a_card_without_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert spmm_acc_experiment.main(["--n", "64", "--band", "8", "--k", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_experiment_bytes_count_each_input_once():
    A = tgen.banded_sin_matrix(100, 8, dtype=np.float32)
    nnz = sum(100 - abs(o) for o in A.offsets)
    assert card.spmm_bytes(A, 3) == nnz * 4 + 2 * 3 * 100 * 4


def test_bound_takes_the_longer_of_bytes_and_operations():
    assert card.bound_ms(3.35e9, 1.0) == pytest.approx((1.0, "bytes"))
    assert card.bound_ms(1.0, 67e9) == pytest.approx((1.0, "operations"))


# ---------------------------------------------------------------------------
# kernel #6's schedule, emulated block by block
# ---------------------------------------------------------------------------

_SRC = (Path(cuda_dia.__file__).parents[1] / "csrc" / "dia.cu").read_text()
#: kernel #6's design constants as the library is built by default
ACC_TILE = int(re.search(r"#define ACC_TILE (\d+)", _SRC).group(1))
ACC_LEGS = int(re.search(r"#define ACC_LEGS (\d+)", _SRC).group(1))
ACC_STAGES = int(re.search(r"#define ACC_STAGES (\d+)", _SRC).group(1))
#: the emulation repeats the twin's fp64 operations in the same order
REL = 1e-12


def acc_schedule(A, X, tile=ACC_TILE, batch=ACC_LEGS, stages=ACC_STAGES):
    """Kernel #6's launch (``csrc/dia.cu::acc_block``) on CPU tensors, one
    block at a time, with the kernel's own decisions: the interior test, the
    coefficient batches (consecutive plan legs across group boundaries, the
    next requested before this one's FMAs, each summed in segments that end
    at group boundaries), the ring of ``stages`` window buffers (groups
    0 .. stages - 2 copied first; opening group g copies group
    g + stages - 1 into buffer (g + stages - 1) % stages; entries outside
    [0, n) not copied).  Returns Y, the writes per row, and the number of
    interior and border blocks."""
    n, k = A.n, X.shape[0]
    groups = plan_dia_groups(tuple(A.offsets))
    legs = [l for g in groups for l in g]  # plan order -> data row
    offs = [A.offsets[l] for l in legs]
    begin = np.cumsum([0] + [len(g) for g in groups]).tolist()
    G, nd = len(groups), len(legs)
    lo, hi = min(0, min(offs)), max(0, max(offs))
    W = tile + max(offs[begin[g + 1] - 1] - offs[begin[g]] for g in range(G))
    Y = torch.full((k, n), float("nan"), dtype=X.dtype)
    writes = torch.zeros(n, dtype=torch.int64)
    blocks = {"interior": 0, "border": 0}
    t = torch.arange(tile)
    for i0 in range(0, n, tile):
        rows = i0 + t
        row_in = rows < n
        interior = i0 + lo >= 0 and i0 + tile + hi <= n
        blocks["interior" if interior else "border"] += 1
        # shared memory holds whatever an earlier block left: NaN here
        bufs = [torch.full((k, W), float("nan"), dtype=X.dtype) for _ in range(stages)]
        holds = [None] * stages

        def stage(g):
            b, e = begin[g], begin[g + 1]
            j = i0 + offs[b] + torch.arange(tile + offs[e - 1] - offs[b])
            ok = (j >= 0) & (j < n)
            buf = bufs[g % stages]
            buf[:, : j.numel()][:, ok] = X[:, j[ok]]
            holds[g % stages] = g

        def load(k0):  # (plan leg, coefficients of the block's rows), or None past the plan
            return [(l, A.data[legs[l], rows.clamp(max=n - 1)]) if l < nd else None
                    for l in range(k0, k0 + batch)]

        y = torch.zeros((k, tile), dtype=X.dtype)
        part = torch.zeros_like(y)
        cur = load(0)
        for p in range(min(stages - 1, G)):
            stage(p)
        summed, opened = [], []
        g, gend = -1, 0
        for k0 in range(0, nd, batch):
            nxt = load(k0 + batch) if k0 + batch < nd else None  # across group boundaries
            bend = min(k0 + batch, nd)
            l = k0
            while l < bend:
                if l == gend:  # open group g + 1: the wait and the barrier
                    g += 1
                    gend = begin[g + 1]
                    assert holds[g % stages] == g  # its window is in
                    if g + stages - 1 < G:
                        stage(g + stages - 1)  # into the buffer group g - 1 was summed from
                        assert holds[g % stages] == g
                    w, s0 = bufs[g % stages], t - offs[l]
                    opened.append(l)
                seg = min(bend, gend)
                for bb in range(batch):
                    ll = k0 + bb
                    if not l <= ll < seg:
                        continue
                    assert cur[bb][0] == ll  # the batch holds the leg the segment sums
                    d, off = cur[bb][1], offs[ll]
                    xv = w[:, s0 + off]
                    summed.append(ll)
                    if interior:
                        part = part + d * xv
                    else:  # a leg whose neighbour leaves [0, n) is not read
                        inside = row_in & (rows + off >= 0) & (rows + off < n)
                        part = torch.where(inside, part + d * torch.where(inside, xv, 0.0), part)
                l = seg
                if l == gend:  # group g is summed
                    y = y + part
                    part = torch.zeros_like(y)
            cur = nxt
        assert summed == list(range(nd))  # every leg once, in plan order
        assert opened == begin[:-1]  # every group opened once, at its first leg
        Y[:, rows[row_in]] = y[:, row_in]
        writes[rows[row_in]] += 1
    return Y, writes, blocks


def _acc_cases():
    """DIA matrices for the emulation: band 32 and 160 (n not a multiple of
    any tile), the 7-point 3-D offsets on a 13^3 grid, a set wider than a
    group's window, and band 160 on fewer rows than one window."""
    rng = np.random.default_rng(12)
    p = 13
    wide = (-900, -500, -3, 0, 2, 450, 700)
    return {
        "band 32 n=1000": tgen.banded_sin_matrix(1000, 32),
        "band 160 n=3001": tgen.banded_sin_matrix(3001, 160),
        "7-point 13^3": DiaMatrix(rng.standard_normal((7, p**3)), (-p * p, -p, -1, 0, 1, p, p * p),
                                  (p**3, p**3)),
        "wide n=2500": DiaMatrix(rng.standard_normal((len(wide), 2500)), wide, (2500, 2500)),
        "band 160 n=100": DiaMatrix(rng.standard_normal((159, 100)), tuple(range(-79, 80)),
                                    (100, 100)),
    }


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("tile,batch,stages", [(ACC_TILE, ACC_LEGS, ACC_STAGES), (128, 16, 2),
                                               (64, 3, 4)])
@pytest.mark.parametrize("name", sorted(_acc_cases()))
def test_acc_schedule_matches_twin(name, tile, batch, stages, k):
    A = _acc_cases()[name].device_put(torch.float64, "cpu")
    X = torch.from_numpy(np.random.default_rng(13).standard_normal((k, A.n)))
    Y, writes, blocks = acc_schedule(A, X, tile, batch, stages)
    ref = spmm_dia_acc_ref(A, X)
    assert torch.equal(writes, torch.ones_like(writes))  # the blocks cover the rows once
    assert not bool(torch.isnan(Y).any())  # no entry outside [0, n) was read
    assert float((Y - ref).abs().max()) <= REL * float(ref.abs().max())
    geo = cuda_dia.acc_geometry(tuple(A.offsets), A.n, k, tile, stages)
    assert (geo.blocks, geo.interior) == (sum(blocks.values()), blocks["interior"])


def test_acc_schedule_reaches_both_paths():
    # band 160 at n = 3001 has interior and border blocks; fewer rows than a
    # window have border blocks only, where every group's window crosses both
    # ends of [0, n)
    A = _acc_cases()["band 160 n=3001"].device_put(torch.float64, "cpu")
    X = torch.from_numpy(np.random.default_rng(14).standard_normal((2, A.n)))
    assert all(acc_schedule(A, X)[2].values())
    A = _acc_cases()["band 160 n=100"].device_put(torch.float64, "cpu")
    assert acc_schedule(A, X[:, :100])[2] == {"interior": 0, "border": 1}


def test_acc_shipped_constants_and_main_shapes():
    assert (ACC_TILE, ACC_LEGS, ACC_STAGES) == (256, 8, 3)
    # the experiment's main shape and the 255^3 seven-diagonal operator: all
    # but a block at either end take the untested path; a ring of three
    # windows takes 29.1 KB at band 160, K = 8, and 36.8 KB for the 255^3
    # operator's three groups at K = 4
    band = cuda_dia.acc_geometry(tuple(range(-79, 80)), 414_720, 8, ACC_TILE, ACC_STAGES)
    assert band == (1620, 1618, 3 * 8 * (256 + 47) * 4)
    p = 255**2
    dia7 = cuda_dia.acc_geometry((-p, -255, -1, 0, 1, 255, p), 255**3, 4, ACC_TILE, ACC_STAGES)
    assert dia7.blocks - dia7.interior == 2 * -(-p // ACC_TILE)
    assert dia7.smem_bytes == 3 * 4 * (256 + 510) * 4
    # a plan of fewer groups than buffers takes one buffer per group
    assert cuda_dia.acc_geometry((-1, 0, 1), 1000, 1, ACC_TILE, ACC_STAGES).smem_bytes == 258 * 4
