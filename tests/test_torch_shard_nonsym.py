"""The port's sharded nonsymmetric family (``parallel.shard_nonsym``) against
the JAX package's, on the CPU.

The JAX side runs under ``shard_map`` on the 8-device CPU mesh of
``tests/conftest.py``; the port on ``make_mesh(k, devices=["cpu"] * k)``,
k shards of one device, kernel #4's twin for every local product.  Both get
the same fp64 arrays from the port's numpy generators.  Each JAX result is
built once per module (one JAX program a configuration).

- A route that has a JAX sharded result on the same inputs takes its count
  exactly, its x within X_REL of the JAX x: MINRES on the indefinite
  Helmholtz, LSMR with and without ``damp`` (on 1, 2 and 4 shards), FGMRES
  with a nonlinear shard-local M, the Chebyshev block loop (and so the
  plain loop, which it equals bit for bit), and the facade's ``jacobi_``,
  ``bjacobi_``, ``chebyshev`` and ``lsmr`` routes.  IDR takes the JAX
  package's draw (``convert.idr_shadow_from_reference``).
- The eps-0.05 convection (transport-dominated: the JAX package's own
  counts move under a one-ulp change of b) holds plain BiCGStab, GMRES and
  IDR to the port's single-device count within the +-2 that the JAX
  package's own tests allow (``tests/test_shard_nonsym.py``), x to the
  direct solve within SOL_REL; the band's BiCGStab and GMRES take the
  single-device count exactly (and the JAX facade's, in
  ``tests/test_torch_gspmd.py``).
- BiCGStab makes exactly two ``psum``s an iteration (one at the start),
  counted by wrapping the port's ``psum``: the counterpart of the JAX
  package's ``test_hlo_two_allreduces_per_bicgstab_iteration``.
- The Chebyshev block loop's x equals the plain loop's bit for bit, with
  one ``psum`` and two ``ppermute``s per ``check_every`` iterations.
- IDR with the JAX draw carried across takes the JAX package's sharded
  count on 1, 2 and 4 shards.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conjugategradient_tpu import api as japi
from conjugategradient_tpu.core import formats as jformats
from conjugategradient_tpu.parallel import make_mesh as j_mesh
from conjugategradient_tpu.parallel import shard_nonsym as jsn
from conjugategradient_tpu.solvers.policy import ConvergencePolicy as JPolicy
from conjugategradient_tpu_torch import api
from conjugategradient_tpu_torch.core import generators as tgen
from conjugategradient_tpu_torch.core import oracle
from conjugategradient_tpu_torch.core.formats import dia_diagonal, dia_to_csr
from conjugategradient_tpu_torch.parallel import make_mesh
from conjugategradient_tpu_torch.parallel import shard_nonsym as sn
from conjugategradient_tpu_torch.parallel.halo import HaloDia
from conjugategradient_tpu_torch.parallel.mesh import shard_rows
from conjugategradient_tpu_torch.solvers.bicgstab import bicgstab_solve
from conjugategradient_tpu_torch.solvers.cheby import estimate_bounds
from conjugategradient_tpu_torch.solvers.gmres import gmres_solve
from conjugategradient_tpu_torch.solvers.policy import ConvergencePolicy

#: the same Krylov sequence in fp64: x within this fraction of max |x| of
#: the JAX package's
X_REL = 1e-10
#: a converged solve against the dense direct solve (max-norm, relative)
SOL_REL = 1e-6
#: the count spread the JAX package's own sharded tests allow against one
#: device
SPREAD = 2
POL = dict(tol=1e-10, norm="rel_l2", max_iteration=4000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small torch ops: one intra-op thread keeps the suite's parallel
    workers from oversubscribing the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mesh(k):
    return make_mesh(k, devices=["cpu"] * k)


def _jA(A):
    return jformats.DiaMatrix(A.data, A.offsets, A.shape)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def band():
    return tgen.nonsymmetric_banded_system(512, 16)


@pytest.fixture(scope="module")
def convdiff():
    s = tgen.convection_diffusion_system((12, 12), eps=0.05)
    return s, oracle.direct_solve(s.A, s.b)


#: IDR's shadow dimension in the JAX comparison
IDR_S = 2


def _one_device(method, s, pol, **kw):
    """The port's single-device solve of ``method`` on ``s`` (fp64, CPU)."""
    A, b = s.A.device_put(torch.float64, "cpu"), torch.from_numpy(s.b)
    if method == "bicgstab":
        return bicgstab_solve(A, b, policy=pol)
    if method == "idr":
        from conjugategradient_tpu_torch.solvers.idr import idr_solve

        return idr_solve(A, b, policy=pol, **kw)
    return gmres_solve(A, b, policy=pol, restart=30)


def _jax_draw(n, s):
    """The JAX package's IDR shadow draw for seed 0, as numpy."""
    return np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n, s), jnp.float64))


@pytest.fixture(scope="module")
def helm():
    return tgen.helmholtz_system((512,), shift=0.05)


@pytest.fixture(scope="module")
def poisson32():
    return tgen.poisson_system((32, 32))


@pytest.fixture(scope="module")
def jax_lsmr(band):
    """The JAX package's sharded LSMR of the band on 4 devices, by damp."""
    return functools.cache(lambda damp: jsn.sharded_lsmr_solve(
        _jA(band.A), band.b, policy=JPolicy(**POL), mesh=j_mesh(4), damp=damp))


@pytest.fixture(scope="module")
def jax_cheb(poisson32):
    """The JAX facade's sharded Chebyshev of Poisson 32^2 on 4 devices,
    check_every 4 (its block loop; its bounds by its own Lanczos)."""
    s = poisson32
    return japi.solve(_jA(s.A), s.b, method="chebyshev", mesh=j_mesh(4), check_every=4, **POL)


@pytest.fixture(scope="module")
def jax_idr(band):
    """The JAX package's sharded IDR(IDR_S) of the band on 1, 2 and 4
    devices: one program a mesh size."""
    return {k: jsn.sharded_nonsym_solve(_jA(band.A), band.b, policy=JPolicy(**POL), method="idr",
                                        mesh=j_mesh(k), s=IDR_S)
            for k in (1, 2, 4)}


@pytest.mark.parametrize("method", ["bicgstab", "gmres"])
def test_band_counts_equal_one_device(band, method):
    """4 shards: the single-device count exactly, x within X_REL."""
    pol = ConvergencePolicy(**POL)
    r = sn.sharded_nonsym_solve(band.A, band.b, policy=pol, method=method, mesh=_mesh(4),
                                restart=30)
    one = _one_device(method, band, pol)
    assert r.converged and one.converged and r.iterations == one.iterations
    assert _rel(r.x, one.x) <= X_REL


@pytest.mark.parametrize("method", ["bicgstab", "gmres", "idr"])
def test_convection_counts_within_spread_of_one_device(convdiff, method):
    """eps 0.05 on 12^2, 4 shards: the port's single-device count within
    SPREAD (the JAX package's allowance; IDR: SPREAD cycles of 5
    matvecs), x against the direct solve."""
    s, x_true = convdiff
    pol = ConvergencePolicy(**POL)
    r = sn.sharded_nonsym_solve(s.A, s.b, policy=pol, method=method, mesh=_mesh(4), restart=30)
    one = _one_device(method, s, pol)
    assert r.converged and one.converged
    assert abs(r.iterations - one.iterations) <= SPREAD * (5 if method == "idr" else 1)
    assert _rel(r.x, x_true) <= SOL_REL


def test_bicgstab_two_psums_per_iteration(band, monkeypatch):
    """Exactly two collectives an iteration (alpha's dot alone, the fused
    (5,)-psum) and one at the start, against the four dots of the
    single-device loop."""
    calls = []
    real = sn.psum

    def counted(x):
        calls.append(tuple(x.shape))
        return real(x)

    monkeypatch.setattr(sn, "psum", counted)
    r = sn.sharded_nonsym_solve(band.A, band.b, policy=ConvergencePolicy(**POL), mesh=_mesh(4))
    assert r.converged and r.iterations > 3
    assert len(calls) == 1 + 2 * r.iterations
    assert calls[0] == (2,) and calls[1:3] == [(), (5,)]


def test_idr_jax_draw_takes_the_jax_sharded_count(band, jax_idr):
    """The JAX package's ``(n, s)`` draw, normalised globally, each shard
    keeping its rows: the JAX sharded count on 1, 2 and 4 shards."""
    draw = _jax_draw(band.n, IDR_S)
    for k in (1, 2, 4):
        r = sn.sharded_nonsym_solve(band.A, band.b, policy=ConvergencePolicy(**POL), method="idr",
                                    mesh=_mesh(k), s=IDR_S, shadow=draw)
        jr = jax_idr[k]
        assert r.converged and r.iterations == int(jr.iterations), k
        assert _rel(r.x, jr.x) <= X_REL, k


def test_fgmres_takes_a_nonlinear_shard_local_preconditioner(convdiff):
    """FGMRES assembles its correction from the sharded Z basis, so a
    shard-local M that is not linear (its scale depends on the shard's own
    rows) still converges to the direct solve: the JAX package's sharded
    FGMRES with the same M on the same shards, its count exactly, its x
    within X_REL."""
    s, x_true = convdiff
    inv = 1.0 / dia_diagonal(s.A)

    def M_local(r, aux):
        z = aux * r
        return z * (1.0 + 0.5 * torch.tanh(z.abs().max()))

    def M_local_jax(r, aux):
        z = aux * r
        return z * (1.0 + 0.5 * jnp.tanh(jnp.abs(z).max()))

    r = sn.sharded_nonsym_solve(s.A, s.b, policy=ConvergencePolicy(**POL), method="fgmres",
                                mesh=_mesh(4), M_local=M_local, M_aux=inv, restart=30)
    jr = jsn.sharded_nonsym_solve(_jA(s.A), s.b, policy=JPolicy(**POL), method="fgmres",
                                  mesh=j_mesh(4), M_local=M_local_jax, M_aux=inv, restart=30)
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL and _rel(r.x, x_true) <= SOL_REL


def test_minres_on_indefinite_helmholtz(helm):
    """Symmetric indefinite, 4 shards: the JAX package's sharded MINRES
    count exactly, x within X_REL of its x and SOL_REL of the direct
    solve."""
    h = helm
    r = sn.sharded_nonsym_solve(h.A, h.b, policy=ConvergencePolicy(**POL), method="minres",
                                mesh=_mesh(4))
    jr = jsn.sharded_nonsym_solve(_jA(h.A), h.b, policy=JPolicy(**POL), method="minres",
                                  mesh=j_mesh(4))
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL
    assert _rel(r.x, oracle.direct_solve(h.A, h.b)) <= SOL_REL


@pytest.mark.parametrize("damp", [0.0, 0.5])
def test_lsmr_shard_count_invariance(band, damp, jax_lsmr):
    """LSMR (A and A^T on the row blocks, two psum'd norms an iteration) on
    1, 2 and 4 shards: the JAX package's 4-device sharded LSMR count
    exactly, x within X_REL of its x."""
    jr = jax_lsmr(damp)
    for k in (1, 2, 4):
        r = sn.sharded_lsmr_solve(band.A, band.b, policy=ConvergencePolicy(**POL), mesh=_mesh(k),
                                  damp=damp)
        assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations), k
        assert _rel(r.x, jr.x) <= X_REL, k


def test_chebyshev_block_loop_is_the_plain_loop(poisson32, jax_cheb, monkeypatch):
    """Poisson 32^2 on 4 shards, check_every 4 (H = 128 <= 256 rows a
    shard): the block loop's x and count are the plain loop's bit for bit,
    and the JAX package's sharded count exactly, x within X_REL; per block
    one psum and two ppermutes (plus the start's psum)."""
    s = poisson32
    pol = ConvergencePolicy(**POL)
    lo, hi = estimate_bounds(s.A)
    m = _mesh(4)
    solve = sn.make_sharded_nonsym(s.A, m, pol, method="chebyshev", bounds=(lo, hi), check_every=4)
    assert solve.route == "chebyshev block"
    data, b = shard_rows(m, s.A.data), shard_rows(m, s.b)
    x0 = shard_rows(m, np.zeros(s.n))
    plain = sn.sharded_chebyshev_loop(HaloDia(data, tuple(s.A.offsets), 32, False), b, x0, pol,
                                      s.n, lo, hi, check_every=4)
    counts = {"psum": 0, "ppermute": 0}
    for name in counts:
        real = getattr(sn, name)

        def counted(*a, real=real, name=name):
            counts[name] += 1
            return real(*a)

        monkeypatch.setattr(sn, name, counted)
    r = solve(data, b, x0)
    assert r.converged and r.iterations == plain.iterations
    assert torch.equal(r.x, plain.x.gather())
    blocks = -(-r.iterations // 4)
    assert counts == {"psum": 1 + blocks, "ppermute": 2 * blocks}
    assert r.iterations == int(jax_cheb.iterations) and _rel(r.x, jax_cheb.x) <= X_REL
    assert _rel(r.x, oracle.direct_solve(s.A, s.b)) <= SOL_REL


def test_chebyshev_takes_the_plain_loop_where_the_block_outreaches_a_shard():
    s = tgen.poisson_system((32, 32))
    lo, hi = estimate_bounds(s.A)
    solve = sn.make_sharded_nonsym(s.A, _mesh(4), ConvergencePolicy(**POL), method="chebyshev",
                                   bounds=(lo, hi), check_every=16)
    assert solve.route == "halo"  # 16 * 32 rows > 256 a shard


def test_allgather_fallback_wide_band():
    """Bandwidth 39 over 32 rows a shard (256 rows, 8 shards): the
    all-gather window; the single-device count within SPREAD."""
    s = tgen.nonsymmetric_banded_system(256, 80)
    pol = ConvergencePolicy(**POL)
    m = _mesh(8)
    assert sn.make_sharded_nonsym(s.A, m, pol).route == "all-gather"
    r = sn.sharded_nonsym_solve(s.A, s.b, policy=pol, mesh=m)
    one = bicgstab_solve(s.A.device_put(torch.float64, "cpu"), torch.from_numpy(s.b), policy=pol)
    assert r.converged and abs(r.iterations - one.iterations) <= SPREAD
    assert _rel(r.x, oracle.direct_solve(s.A, s.b)) <= SOL_REL


def test_linf_norm(band):
    pol = ConvergencePolicy(tol=1e-8, norm="linf")
    r = sn.sharded_nonsym_solve(band.A, band.b, policy=pol, method="gmres", restart=40,
                                mesh=_mesh(4))
    res = band.b - oracle.spmv(band.A, r.x.numpy())
    assert r.converged and np.abs(res).max() < 1e-7


@pytest.mark.parametrize("method", ["jacobi_bicgstab", "bjacobi_gmres", "jacobi_idr"])
def test_facade_shard_local_preconditioners(convdiff, method):
    """``api.solve(mesh=)``'s jacobi_ and bjacobi_ routes on 4 shards: the
    JAX facade's sharded count exactly (IDR from the JAX draw), x within
    X_REL of its x and SOL_REL of the direct solve."""
    s, x_true = convdiff
    opts = dict(method=method, **POL)
    if method.startswith("bjacobi"):
        opts["block_size"] = 4  # divides the 36 rows a shard
    extra = dict(shadow=_jax_draw(s.n, 4)) if method.endswith("idr") else {}
    r = api.solve(s.A, s.b, mesh=_mesh(4), dtype=np.float64, **opts, **extra)
    jr = japi.solve(_jA(s.A), s.b, mesh=j_mesh(4), **opts)
    assert r.converged and bool(jr.converged) and r.iterations == int(jr.iterations)
    assert _rel(r.x, jr.x) <= X_REL and _rel(r.x, x_true) <= SOL_REL


def test_facade_chebyshev_and_lsmr_routes(band, poisson32, jax_cheb, jax_lsmr):
    """chebyshev with mesh= estimates its bounds (the JAX facade's, whose
    count it takes exactly, x within X_REL); lsmr with mesh= is the sharded
    LSMR (the JAX package's count exactly, x within X_REL)."""
    s = poisson32
    r = api.solve(s.A, s.b, method="chebyshev", mesh=_mesh(4), check_every=4, dtype=np.float64,
                  **POL)
    assert r.converged and r.iterations == int(jax_cheb.iterations)
    assert _rel(r.x, jax_cheb.x) <= X_REL
    assert _rel(r.x, oracle.direct_solve(s.A, s.b)) <= SOL_REL
    r = api.solve(band.A, band.b, method="lsmr", mesh=_mesh(4), dtype=np.float64, **POL)
    jr = jax_lsmr(0.0)
    assert r.converged and r.iterations == int(jr.iterations) and _rel(r.x, jr.x) <= X_REL


#: (method, keywords, matrix kind) -> the error both facades raise with mesh=
REFUSALS = [
    ("fgmres", dict(inner="bicgstab"), "dia", ValueError, "does not take inner="),
    ("mg_minres", dict(grid=(16, 16)), "dia", ValueError, "not supported"),
    ("mg_bicgstab", {}, "dia", ValueError, "requires grid="),
    ("mg_bicgstab", dict(grid=(16, 16)), "csr", TypeError, "DiaMatrix"),
    ("lsmr", {}, "csr", TypeError, "square-banded DiaMatrix"),
    ("jacobi_chebyshev", {}, "dia", ValueError, "no preconditioner prefix"),
    ("amg_idr", {}, "dia", ValueError, "not supported"),
    ("bjacobi_bicgstab", dict(block_size=7), "dia", ValueError, "to divide the shard length"),
]


@pytest.mark.parametrize("case", REFUSALS, ids=lambda c: f"{c[0]}-{c[2]}")
def test_facade_refusals_match_jax(case):
    method, kw, kind, err, msg = case
    s = tgen.poisson_system((16, 16))
    A = s.A if kind == "dia" else dia_to_csr(s.A)
    jA = _jA(s.A) if kind == "dia" else jformats.dia_to_csr(_jA(s.A))
    with pytest.raises(err, match=msg):
        api.solve(A, s.b, method=method, mesh=_mesh(4), **kw)
    with pytest.raises(err, match=msg):
        japi.solve(jA, s.b, method=method, mesh=j_mesh(4), **kw)


def test_factory_refusals():
    s = tgen.poisson_system((16, 16))
    with pytest.raises(ValueError, match="unknown method"):
        sn.make_sharded_nonsym(s.A, _mesh(4), method="cg")
    with pytest.raises(ValueError, match="requires bounds"):
        sn.make_sharded_nonsym(s.A, _mesh(4), method="chebyshev")
    with pytest.raises(ValueError, match="not divisible"):
        sn.make_sharded_nonsym(s.A, _mesh(3))
    with pytest.raises(ValueError, match="not divisible"):
        sn.make_sharded_lsmr(s.A, _mesh(3))
    with pytest.raises(TypeError, match="DiaMatrix"):
        api.solve(dia_to_csr(s.A), s.b, method="bicgstab", mesh=_mesh(4))
