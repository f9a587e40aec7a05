"""The port's aggregation, hybrid and partial (semicoarsening) transfers and
the red-black Gauss-Seidel smoother against the JAX package, on the CPU:
seeded numpy inputs through both, fp64.  The grid forms are also held to
their own scipy matrices (P e, and R r = P^T r / 2 per coarsened axis), the
adjoint pair that keeps the V-cycle symmetric."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from conjugategradient_tpu.precond import smoothers as jsm
from conjugategradient_tpu.precond import transfer as jtr
from conjugategradient_tpu_torch.precond import smoothers as tsm
from conjugategradient_tpu_torch.precond import transfer as ttr

#: 1-D, 2-D and 3-D shapes with odd tails and even axes
AGG_SHAPES = [(9,), (10,), (7, 10), (6, 5), (5, 6, 7), (4, 4, 3)]
HYB_SHAPES = [(9,), (10,), (7, 10), (6, 5), (5, 6, 7), (4, 4, 3), (2, 3)]
#: (shape, mask) of the semicoarsening transfers
PARTIAL_CASES = [((10, 7), (True, False)), ((10, 7), (False, True)), ((6, 5, 8), (True, False, True)),
                 ((6, 5, 8), (False, True, False)), ((9,), (True,)), ((4, 4), (True, True))]


def _families():
    """(label, shape, (port R, port P, port matrix), (JAX R, JAX P, JAX matrix))."""
    out = []
    for g in AGG_SHAPES:
        out.append((f"agg {g}", g, (ttr.restrict_agg_grid, ttr.prolong_agg_grid,
                                     ttr.prolong_agg_matrix, ttr.agg_coarse_shape(g)),
                    (jtr.restrict_agg_grid, jtr.prolong_agg_grid, jtr.prolong_agg_matrix), len(g)))
    for g in HYB_SHAPES:
        out.append((f"hyb {g}", g, (ttr.restrict_hybrid_grid, ttr.prolong_hybrid_grid,
                                     ttr.prolong_hybrid_matrix, ttr.hybrid_coarse_shape(g)),
                    (jtr.restrict_hybrid_grid, jtr.prolong_hybrid_grid, jtr.prolong_hybrid_matrix),
                    len(g)))
    for g, m in PARTIAL_CASES:
        out.append((f"partial {g} {m}", g,
                    (lambda v, m=m: ttr.restrict_partial_grid(v, m),
                     lambda e, f, m=m: ttr.prolong_partial_grid(e, f, m),
                     lambda f, m=m: ttr.prolong_partial_matrix(f, m), ttr.partial_coarse_shape(g, m)),
                    (lambda v, m=m: jtr.restrict_partial_grid(v, m),
                     lambda e, f, m=m: jtr.prolong_partial_grid(e, f, m),
                     lambda f, m=m: jtr.prolong_partial_matrix(f, m)), sum(m)))
    return {label: rest for label, *rest in out}


FAMILIES = _families()


@pytest.mark.parametrize("case", sorted(FAMILIES))
def test_transfer_matches_jax_and_its_scipy_matrix(case):
    g, (r_t, p_t, mat_t, coarse), (r_j, p_j, mat_j), d = FAMILIES[case]
    rng = np.random.default_rng(sum(g) + d)
    v = rng.standard_normal(g)
    e = rng.standard_normal(coarse)
    rt = r_t(torch.from_numpy(v))
    pt = p_t(torch.from_numpy(e), g)
    assert tuple(rt.shape) == coarse and tuple(pt.shape) == g
    assert rt.is_contiguous() and pt.is_contiguous()
    np.testing.assert_allclose(rt.numpy(), np.asarray(r_j(jnp.asarray(v))), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(pt.numpy(), np.asarray(p_j(jnp.asarray(e), g)), rtol=1e-12,
                               atol=1e-12)
    # the scipy matrix: bit-identical to the JAX one, and the grid forms are
    # P e and P^T v / 2^(coarsened axes)
    P, Pj = mat_t(g), mat_j(g)
    assert P.shape == Pj.shape == (int(np.prod(g)), int(np.prod(coarse)))
    assert (P != Pj).nnz == 0
    np.testing.assert_allclose(pt.numpy().reshape(-1), P @ e.reshape(-1), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(rt.numpy().reshape(-1), (P.T @ v.reshape(-1)) * 0.5 ** d,
                               rtol=1e-12, atol=1e-12)


def test_coarsening_predicates_match_jax():
    shapes = [(1,), (2,), (3,), (4,), (7, 1), (6, 8), (5, 2, 9), (0, 3)]
    for g in shapes:
        assert ttr.can_aggregate(g) == jtr.can_aggregate(g)
        assert ttr.can_hybrid(g) == jtr.can_hybrid(g)
        assert ttr.hybrid_kinds(g) == jtr.hybrid_kinds(g)
        for m in [(True,) * len(g), (False,) * len(g), (True,) + (False,) * (len(g) - 1)]:
            assert ttr.can_partial(g, m) == jtr.can_partial(g, m)
            assert ttr.partial_kinds(g, m) == jtr.partial_kinds(g, m)
    assert ttr.agg_coarse_shape((5, 6)) == jtr.agg_coarse_shape((5, 6)) == (3, 3)
    with pytest.raises(ValueError, match="not aggregatable"):
        ttr.agg_coarse_shape((1, 4))
    with pytest.raises(ValueError, match="not hybrid-coarsenable"):
        ttr.hybrid_coarse_shape((1, 4))
    with pytest.raises(ValueError, match="not partial-coarsenable"):
        ttr.partial_coarse_shape((1, 4), (True, False))


@pytest.mark.parametrize("grid", [(9,), (6, 7), (4, 5, 3)])
def test_redblack_gs_matches_jax(grid):
    mask_t, mask_j = tsm.parity_mask(grid), jsm.parity_mask(grid)
    np.testing.assert_array_equal(mask_t.numpy(), np.asarray(mask_j))
    rng = np.random.default_rng(len(grid))
    n = int(np.prod(grid))
    M = rng.standard_normal((n, n))
    M = M @ M.T + n * np.eye(n)
    inv_d = 1.0 / np.diag(M).reshape(grid)
    b, x = rng.standard_normal(grid), rng.standard_normal(grid)
    op_t = lambda v: torch.from_numpy(M) @ v.reshape(-1)
    op_j = lambda v: jnp.asarray(M) @ v.reshape(-1)
    for fn_t, fn_j in ((tsm.redblack_gs_smooth, jsm.redblack_gs_smooth),
                       (tsm.redblack_gs_smooth_reversed, jsm.redblack_gs_smooth_reversed)):
        yt = fn_t(lambda v: op_t(v).reshape(grid), torch.from_numpy(inv_d), torch.from_numpy(b),
                  torch.from_numpy(x), 2, mask_t)
        yj = fn_j(lambda v: op_j(v).reshape(grid), jnp.asarray(inv_d), jnp.asarray(b),
                  jnp.asarray(x), 2, mask_j)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-12, atol=1e-12)
