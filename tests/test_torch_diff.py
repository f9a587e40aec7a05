"""Differentiable solves of the port (``solvers.diff``) against the JAX
package's ``jax.grad``, on the CPU in fp64.

The forward pass equals ``cg_solve``; the gradients of a scalar loss with
respect to ``data`` and ``b`` through ``cg_solve_implicit`` (symmetric,
adjoint by CG on A) and ``bicgstab_solve_implicit`` (nonsymmetric, adjoint
by BiCGStab on the transpose) equal the JAX package's within GRAD_REL;
``dia_transpose_traced`` equals ``formats.transpose``; the inverse-problem
demo descends.  ``torch.func.vmap`` over both solves is held to
``jax.vmap`` in ``tests/test_torch_batched.py``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from conjugategradient_tpu.core import generators as jgen
from conjugategradient_tpu.solvers import diff as jdiff
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch.core import formats
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.scripts.inverse_demo import recover
from conjugategradient_tpu_torch.solvers import diff
from conjugategradient_tpu_torch.solvers.cg import cg_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same fp64 forward and adjoint solves: gradients within this fraction
#: of their largest entry (3e-16 and 1e-15 measured)
GRAD_REL = 1e-10
POL = dict(tol=1e-13, norm="rel_l2", max_iteration=2000)
NONSYM_POL = dict(tol=1e-12, norm="rel_l2", max_iteration=4000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _leaf(a):
    return torch.from_numpy(np.array(a)).requires_grad_()


def _close(got, want):
    want = np.asarray(want)
    assert np.abs(got.detach().numpy() - want).max() <= GRAD_REL * np.abs(want).max()


def test_forward_equals_cg_and_the_gradients_equal_jax():
    s = tgen.banded_sin_system(64, 8)
    offs, shape = s.A.offsets, s.A.shape
    w = np.random.default_rng(0).standard_normal(s.n)
    data, b = _leaf(s.A.data), _leaf(s.b)
    x = diff.cg_solve_implicit(data, b, offs, shape, ConvergencePolicy(**POL))
    ref = cg_solve(s.A, torch.from_numpy(s.b), policy=ConvergencePolicy(**POL)).x
    assert torch.equal(x.detach(), ref)
    torch.dot(torch.from_numpy(w), x).backward()

    def jloss(d, bb):
        return jnp.vdot(jnp.asarray(w), jdiff.cg_solve_implicit(d, bb, offs, shape, JPolicy(**POL)))

    gd, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(s.A.data), jnp.asarray(s.b))
    _close(data.grad, gd)
    _close(b.grad, gb)
    # only what requires grad gets one
    d2 = torch.from_numpy(s.A.data.copy())
    b2 = _leaf(s.b)
    diff.cg_solve_implicit(d2, b2, offs, shape, ConvergencePolicy(**POL)).sum().backward()
    assert d2.grad is None and b2.grad is not None


def test_nonsymmetric_gradient_equals_jax():
    s = tgen.convection_diffusion_system((8, 8), eps=0.3)
    sj = jgen.convection_diffusion_system((8, 8), eps=0.3)
    offs, shape = s.A.offsets, s.A.shape
    data, b = _leaf(s.A.data), _leaf(s.b)
    x = diff.bicgstab_solve_implicit(data, b, offs, shape, ConvergencePolicy(**NONSYM_POL))
    torch.sum(torch.sin(x)).backward()

    def jloss(d, bb):
        return jnp.sum(jnp.sin(jdiff.bicgstab_solve_implicit(d, bb, offs, shape,
                                                             JPolicy(**NONSYM_POL))))

    gd, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(sj.A.data), jnp.asarray(sj.b))
    _close(data.grad, gd)
    _close(b.grad, gb)


@pytest.mark.parametrize("kind", ["convection 6^2", "band 300 diagonals"])
def test_dia_transpose_traced_equals_formats_transpose(kind):
    if kind == "convection 6^2":
        A = tgen.convection_diffusion_matrix((6, 6), eps=0.2)
    else:
        A = tgen.nonsymmetric_banded_matrix(600, 302)
    dT = diff.dia_transpose_traced(torch.from_numpy(A.data), A.offsets, A.n).numpy()
    At = formats.transpose(A)
    # transpose sorts the negated offsets; the traced form keeps A's order
    order = np.argsort([-o for o in A.offsets], kind="stable")
    assert At.offsets == tuple(-A.offsets[k] for k in order)
    np.testing.assert_array_equal(dT[order], At.data)
    if A.ndiags < 16:  # the JAX package's eager per-diagonal ops take seconds past that
        j = jdiff.dia_transpose_traced(jnp.asarray(A.data), A.offsets, A.n)
        np.testing.assert_array_equal(dT, np.asarray(j))


def test_vmap_is_refused_and_the_inverse_demo_descends():
    # the vmap refusal went with the vmap rules (tests/test_torch_batched.py)
    out = recover(n=48, band=6, steps=15, device="cpu")
    assert out["losses"][-1] < 0.5 * out["losses"][0]
    assert out["loss"] < out["losses"][-1]
