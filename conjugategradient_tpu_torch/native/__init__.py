"""ctypes loader of the host C++ kit (``csrc/csrkit.cpp``), with numpy
fallbacks.

The port of ``conjugategradient_tpu/native``: COO -> CSR assembly, CSR ->
DIA and CSR -> ELL conversion, per-shard halo ranges, the banded
``|sin(i+j)|`` generator in DIA layout, an OpenMP CSR SpMV and CG (the
fp64 oracle's policy; ``api.solve(method="native")``) and the greedy
aggregation of the AMG setup.  All of it runs on the host, in fp64: it
takes and returns host numpy containers of ``core.formats`` and never
touches the card.

``ops._build.build_host`` compiles the kit with the host compiler
(``$CXX``, else ``g++``) and ``-fopenmp`` at first use, into
``conjugategradient_tpu_torch/_build/``, and without ``-fopenmp`` where
the compiler has no OpenMP.  Where there is no compiler at all
``available()`` is False and every function runs its numpy counterpart
in ``core``, as the JAX kit does; ``aggregate`` returns ``None`` and its caller runs the
Python loop.  A compiler that fails raises: a broken build never passes
for a missing one.  As in the JAX kit, a container whose values are not
fp64 takes the numpy path.
"""

from __future__ import annotations

import ctypes

import numpy as np

from conjugategradient_tpu_torch.core import formats, oracle, partition
from conjugategradient_tpu_torch.ops import _build

_NORM_CODE = {"l2": 0, "linf": 1, "rel_l2": 2}


def _load():
    """The loaded kit, built first if needed, or ``None`` where there is no
    host compiler."""
    try:
        return _build.load_host("csrkit")
    except _build.NoHostCompiler:
        return None


def available() -> bool:
    """Whether the C++ kit is built and loaded (False: the numpy paths run)."""
    return _load() is not None


def threads() -> int:
    """Threads the kit's OpenMP regions run on (``OMP_NUM_THREADS`` or the
    cores); 0 where it was built without OpenMP or is not available."""
    lib = _load()
    return 0 if lib is None else int(lib.csrkit_threads())


def _c(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=dtype)


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _fp64(A) -> bool:
    return np.asarray(A.data).dtype == np.float64


def coo_to_csr(coo):
    """COO -> CSR, duplicates summed: ``formats.coo_to_csr``'s arrays (equal
    where no (row, col) repeats; repeats sum in the kit's sort order)."""
    lib = _load()
    if lib is None or not _fp64(coo):
        return formats.coo_to_csr(coo)
    n, nnz = coo.shape[0], coo.nnz
    rows, cols, vals = _c(coo.rows, np.int32), _c(coo.cols, np.int32), _c(coo.data, np.float64)
    indptr = np.zeros(n + 1, dtype=np.int32)
    indices = np.empty(nnz, dtype=np.int32)
    data = np.empty(nnz, dtype=np.float64)
    rowids = np.empty(nnz, dtype=np.int32)
    m = int(lib.csrkit_coo_to_csr(n, nnz, _ptr(rows), _ptr(cols), _ptr(vals), _ptr(indptr),
                                  _ptr(indices), _ptr(data), _ptr(rowids)))
    return formats.CsrMatrix(data[:m].copy(), indices[:m].copy(), indptr, rowids[:m].copy(),
                             coo.shape)


def csr_spmv(csr, x: np.ndarray) -> np.ndarray:
    """y = A x over the CSR's rows, OpenMP across rows, in fp64."""
    lib = _load()
    if lib is None or not _fp64(csr):
        return oracle.spmv(csr, x)
    y = np.empty(csr.n, dtype=np.float64)
    ip, ix = _c(csr.indptr, np.int32), _c(csr.indices, np.int32)
    d, xv = _c(csr.data, np.float64), _c(x, np.float64)
    lib.csrkit_spmv(csr.n, _ptr(ip), _ptr(ix), _ptr(d), _ptr(xv), _ptr(y))
    return y


def halo_ranges(csr, part):
    """Each shard's exact column range ``(minJ, maxJ)`` under the
    ``core.partition.RowBlockPartition`` ``part``
    (``partition.halo_ranges_from_csr``)."""
    lib = _load()
    if lib is None:
        return partition.halo_ranges_from_csr(csr, part)
    s = part.num_shards
    minj = np.empty(s, dtype=np.int32)
    maxj = np.empty(s, dtype=np.int32)
    offs, cnts = _c(part.offsets, np.int64), _c(part.counts, np.int64)
    ip, ix = _c(csr.indptr, np.int32), _c(csr.indices, np.int32)
    lib.csrkit_halo_ranges(s, _ptr(offs), _ptr(cnts), _ptr(ip), _ptr(ix), _ptr(minj), _ptr(maxj))
    return tuple((int(a), int(b)) for a, b in zip(minj, maxj))


def csr_to_dia(csr, offsets=None):
    """CSR -> DIA (``formats.csr_to_dia``): ``offsets`` default to every
    structurally present diagonal, ascending; an entry outside a given set
    raises ``ValueError``."""
    lib = _load()
    if lib is None or not _fp64(csr):
        return formats.csr_to_dia(csr, offsets)
    n = csr.n
    ip, ix, vals = _c(csr.indptr, np.int32), _c(csr.indices, np.int32), _c(csr.data, np.float64)
    if offsets is None:
        present = np.zeros(2 * n - 1, dtype=np.uint8)
        lib.csrkit_diag_census(n, _ptr(ip), _ptr(ix), _ptr(present))
        offsets = tuple(int(d) - (n - 1) for d in np.nonzero(present)[0])
    off = _c(offsets, np.int64)
    data = np.zeros((len(offsets), n), dtype=np.float64)
    if lib.csrkit_csr_to_dia(n, _ptr(ip), _ptr(ix), _ptr(vals), len(offsets), _ptr(off),
                             _ptr(data)) != 0:
        raise ValueError("matrix has entries outside the requested diagonal set")
    return formats.DiaMatrix(data, tuple(offsets), (n, n))


def csr_to_ell(csr, k=None):
    """CSR -> diagonal-first ELL (``formats.csr_to_ell``); a row past ``k``
    entries raises ``ValueError``."""
    lib = _load()
    if lib is None or not _fp64(csr):
        return formats.csr_to_ell(csr, k)
    n, m = csr.shape
    counts = np.diff(np.asarray(csr.indptr))
    kmax = int(counts.max()) if n else 0
    width = kmax if k is None else k
    if kmax > width:
        raise ValueError(f"row with {kmax} nonzeros exceeds ELL width k={width}")
    data = np.zeros((n, width), dtype=np.float64)
    cols = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
    ip, ix, vals = _c(csr.indptr, np.int32), _c(csr.indices, np.int32), _c(csr.data, np.float64)
    if lib.csrkit_csr_to_ell(n, _ptr(ip), _ptr(ix), _ptr(vals), width, _ptr(data),
                             _ptr(cols)) != 0:
        raise ValueError("row exceeds ELL width")
    return formats.EllMatrix(data, cols, (n, m))


def cg(csr, b, x0=None, tol: float = 1e-8, norm: str = "l2",
       min_iteration: int = 0, max_iteration=None, raise_on_divergence: bool = True):
    """OpenMP CSR CG in fp64, the counterpart of ``core.oracle.cg``: the
    same policy (``min_iteration`` inclusive; ``max_iteration``, default n,
    then ``oracle.NotConvergedError`` or ``converged=False``), the l2, linf
    and rel_l2 norms, and alpha and beta 0 where their denominator is 0.
    Returns an ``oracle.OracleResult`` with a host x and no history.  With
    ``max_iteration=None`` a system whose residual stalls above ``tol``
    runs n iterations."""
    lib = _load()
    if lib is None or not _fp64(csr):
        return oracle.cg(csr, b, x0, tol=tol, norm=norm, min_iteration=min_iteration,
                         max_iteration=max_iteration, raise_on_divergence=raise_on_divergence)
    n = csr.n
    if max_iteration is None:
        max_iteration = n
    x = np.zeros(n) if x0 is None else np.array(x0, dtype=np.float64)
    res = ctypes.c_double(0.0)
    ip, ix, d = _c(csr.indptr, np.int32), _c(csr.indices, np.int32), _c(csr.data, np.float64)
    bv = _c(b, np.float64)
    it = int(lib.csrkit_cg(n, _ptr(ip), _ptr(ix), _ptr(d), _ptr(bv), _ptr(x), float(tol),
                           _NORM_CODE[norm], int(min_iteration), int(max_iteration),
                           ctypes.byref(res)))
    if it < 0:
        if raise_on_divergence:
            raise oracle.NotConvergedError(
                f"native CG did not converge in {-it - 1} iterations (residual={res.value:.3e})"
            )
        return oracle.OracleResult(x, -it - 1, res.value, False, [])
    return oracle.OracleResult(x, it, res.value, True, [])


def aggregate(indptr: np.ndarray, indices: np.ndarray, absdata: np.ndarray):
    """Greedy smoothed-aggregation clustering over a strength-graph CSR
    (``|data|`` precomputed): ``(aggregate id per node, int64; number of
    aggregates)``, the same as ``precond.amg._aggregate_python`` bit for
    bit.  ``None`` where the kit is not available."""
    lib = _load()
    if lib is None:
        return None
    n = len(indptr) - 1
    out = np.empty(n, dtype=np.int64)
    ip, ix, ad = _c(indptr, np.int32), _c(indices, np.int32), _c(absdata, np.float64)
    n_agg = lib.csrkit_aggregate(n, _ptr(ip), _ptr(ix), _ptr(ad), _ptr(out))
    return out, int(n_agg)


def banded_sin_dia(n: int, band: int):
    """The banded ``|sin(i+j)|`` SPD matrix (``generators.
    banded_sin_matrix``) emitted directly in DIA layout, fp64."""
    lib = _load()
    if lib is None:
        from conjugategradient_tpu_torch.core import generators

        return generators.banded_sin_matrix(n, band)
    h = band // 2 - 1
    data = np.zeros((2 * h + 1, n), dtype=np.float64)
    lib.csrkit_banded_sin_dia(n, band, _ptr(data))
    return formats.DiaMatrix(data, tuple(range(-h, h + 1)), (n, n))
