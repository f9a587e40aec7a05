"""``device=None`` means the card when there is one, at every entry point.

The JAX package places on its default backend; the port's entry points
resolve ``device=None`` the same way (``core.formats.default_device``).
Without a card (a CPU-only torch build) one is faked:
``torch.cuda.is_available`` answers True, and any move of a tensor to a
CUDA device raises ``_WentToCuda`` before it happens, so each test reads
the resolved device, not a launch.
An explicit ``device="cpu"`` must still win under the same fake.
"""

import numpy as np
import pytest
import torch

from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.convert import hierarchy_from_reference
from conjugategradient_tpu_torch.core import generators
from conjugategradient_tpu_torch.core.formats import default_device, dia_to_stencil
from conjugategradient_tpu_torch.precond.multigrid import build_hierarchy, mgcg_solve
from conjugategradient_tpu_torch.solvers.refine import refined_solve, refined_solve_multi


class _WentToCuda(Exception):
    pass


@pytest.fixture
def fake_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    to = torch.Tensor.to

    def guarded_to(self, *args, **kwargs):
        for v in (*args, *kwargs.values()):
            if isinstance(v, (str, torch.device)) and torch.device(v).type == "cuda":
                raise _WentToCuda(str(v))
        return to(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "to", guarded_to)


GRID = (15, 15)


def _entry_points():
    """name -> f(device): each entry point that takes ``device``, on a small
    system (15^2 is below ``max_coarse``: a hierarchy without levels)."""
    s = generators.poisson_system(GRID)
    B = np.stack([s.b, 2 * s.b], axis=1)
    tri = generators.tridiagonal_system(63)
    return {
        "DiaMatrix.device_put": lambda d: s.A.device_put(np.float32, d),
        "StencilMatrix.device_put": lambda d: dia_to_stencil(s.A, GRID).device_put(np.float32, d),
        "build_hierarchy": lambda d: build_hierarchy(s.A, GRID, device=d),
        "mgcg_solve": lambda d: mgcg_solve(s.A, s.b, GRID, device=d),
        "hierarchy_from_reference": lambda d: hierarchy_from_reference(
            [], np.eye(3), "chebyshev", 2, 2, 2 / 3, device=d),
        "refined_solve": lambda d: refined_solve(tri.A, tri.b, device=d),
        "refined_solve device_residual": lambda d: refined_solve(tri.A, tri.b, device_residual=True,
                                                                 device=d),
        "refined_solve grid": lambda d: refined_solve(s.A, s.b, grid=GRID, device=d),
        "refined_solve_multi": lambda d: refined_solve_multi(tri.A, np.stack([tri.b, tri.b], 1),
                                                             device=d),
        "refined_solve_multi grid": lambda d: refined_solve_multi(s.A, B, grid=GRID, device=d),
        "api.solve mgcg": lambda d: api.solve(s.A, s.b, method="mgcg", grid=GRID, device=d),
        "api.solve (n, k) mgcg": lambda d: api.solve(s.A, B, method="mgcg", grid=GRID, device=d),
    }


ENTRY_POINTS = sorted(_entry_points())


def _call(name, device):
    return _entry_points()[name](device)


def test_default_device_resolves_to_the_card(fake_card):
    assert default_device() == torch.device("cuda")
    assert default_device("cpu") == torch.device("cpu")
    assert default_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


def test_default_device_is_the_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert default_device() == torch.device("cpu")


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_takes_the_card_by_default(fake_card, name):
    with pytest.raises(_WentToCuda, match="cuda"):
        _call(name, None)


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_explicit_cpu_still_wins(fake_card, name):
    _call(name, "cpu")
