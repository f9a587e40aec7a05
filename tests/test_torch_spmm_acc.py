"""Kernel #6's module on the CPU: the single-call accumulating DIA SpMM.

The twin ``spmm_dia_acc_ref`` (the kernel's group plan and rounding order on
whole arrays) is held to the JAX package's multi-RHS Pallas kernel in
interpret mode and to its XLA ``spmm_dia``, on the same inputs made from a
numpy seed; the group plan to its contract; the experiment module
``scripts/spmm_acc_experiment.py`` to its record on the CPU.  The kernel
itself is compared with the twin on the card (``chip_smoke.py``,
``tests/test_torch_cuda.py``).
"""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.ops.pallas_spmv import spmm_dia_pallas
from conjugategradient_tpu.ops.spmm import spmm_dia as j_spmm_dia
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core.formats import DiaMatrix
from conjugategradient_tpu_torch.ops import card
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
