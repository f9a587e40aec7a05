"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each source (``stencil.cu``, ``stencil_var.cu``, ``dia.cu``) becomes its
own shared library, compiled by ``nvcc`` from the package's own sources into
``conjugategradient_tpu_torch/_build/`` under a name keyed on a hash of that
source and the flags, so a fresh checkout builds it on the first kernel
launch and an edited source rebuilds it.  ``build()`` starts one ``nvcc`` per
missing library, all together, and waits for them.  The C interfaces take
plain pointers and the stream as ``void*``; every pointer argument is
declared ``c_void_p`` so ctypes does not cut it to 32 bits.

The host C++ source (``csrkit.cpp``, the host kit of ``native``: format
conversions, an OpenMP CSR CG, the AMG setup's greedy aggregation) builds
the same way with the host compiler (``$CXX``, else ``g++``), which the
CPU machines have too: ``build_host`` / ``load_host``, with the source's
own flags (``HOST_FLAGS``: ``-fopenmp``) and again without them where the
compiler refuses them (no OpenMP).  A failed build raises; nothing falls
back.  Where ``$CXX`` is unset and no ``g++`` is on the path,
``build_host`` raises ``NoHostCompiler``: ``native`` then runs its numpy
fallbacks, as the JAX package's kit does without a compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

_PKG = Path(__file__).resolve().parent.parent
SOURCES = {
    "stencil": _PKG / "csrc" / "stencil.cu",
    "stencil_var": _PKG / "csrc" / "stencil_var.cu",
    "dia": _PKG / "csrc" / "dia.cu",
}
HOST_SOURCES = {"csrkit": _PKG / "csrc" / "csrkit.cpp"}
#: each host source's own flags, dropped on a second try where the compiler
#: refuses them (never ``-march=native``: the library runs where it was built,
#: but its arithmetic must not depend on the build host)
HOST_FLAGS = {"csrkit": ("-fopenmp",)}
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_DP = ctypes.POINTER(ctypes.c_double)
_IP = ctypes.POINTER(ctypes.c_int)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def _flags(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in defines)


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    h = hashlib.sha256(" ".join(_flags(defines)).encode())
    h.update(SOURCES[name].read_bytes())
    return BUILD_DIR / f"libcg_{name}_{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None, defines: Tuple[str, ...] = ()) -> Dict[str, Path]:
    """Compile every named library (default: all) unless a build of its
    current source exists, one ``nvcc`` per source, started together.
    ``defines`` (``"NAME=value"``) override a source's compile-time design
    constants, for the tuning scripts (``scripts/stencil_tuning.py``,
    ``scripts/dia_tuning.py``).
    ``nvcc``'s output (including ``-Xptxas -v``) is kept beside each library
    as ``.log``.  Returns ``{name: library path}``."""
    names = list(SOURCES) if names is None else list(names)
    outs = {name: library_path(name, defines) for name in names}
    todo = {name: out for name, out in outs.items() if not out.exists()}
    if not todo:
        return outs
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = []
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen([nvcc, *_flags(defines), "-o", str(tmp), str(SOURCES[name])],
                                stdout=log, stderr=subprocess.STDOUT)
        running.append((name, out, tmp, log, proc))
    failed = []
    for name, out, tmp, log, proc in running:
        rc = proc.wait()
        log.close()
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {rc}):\n{out.with_suffix('.log').read_text()[-4000:]}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return outs


def kernel_resources(name: str, defines: Tuple[str, ...] = ()) -> Dict[str, Dict[str, int]]:
    """Per kernel entry of a built library, what ``ptxas -v`` reported:
    ``{mangled entry: {"registers", "stack", "spill_stores", "spill_loads"}}``."""
    out, entry = {}, None
    for line in library_path(name, defines).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = out.setdefault(m.group(1), {})
            continue
        if entry is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            entry.update(stack=int(m[1]), spill_stores=int(m[2]), spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            entry["registers"] = int(m[1])
    return out


def _bind_stencil(lib: ctypes.CDLL) -> None:
    lib.cg_spmv_const.argtypes = [_I, _I, _P, _P, _I, _I, _I, _I, _DP, _IP, _I, _I, _I, _I, _I, _P]
    lib.cg_spmv_const.restype = _I
    lib.cg_spmv_const_zrun.argtypes = [_I]
    lib.cg_spmv_const_zrun.restype = _I
    lib.cg_cheb_const.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _FP, _IP, _I, _I, _I, _I, _I,
        ctypes.c_float, _FP, _FP, _P,
    ]
    lib.cg_cheb_const.restype = _I


def _bind_stencil_var(lib: ctypes.CDLL) -> None:
    lib.cg_spmv_var.argtypes = [_I, _I, _P, _P, _P, _I, _I, _I, _I, _IP, _P]
    lib.cg_spmv_var.restype = _I
    lib.cg_spmv_var_wide.argtypes = [_I, _P, _P, _P, _P] + [_I] * 11 + [_P]
    lib.cg_spmv_var_wide.restype = _I


def _bind_dia(lib: ctypes.CDLL) -> None:
    lib.cg_spmv_dia.argtypes = [_I, _P, _P, _P, _I, _I, _IP, _I, _P]
    lib.cg_spmv_dia.restype = _I
    lib.cg_spmv_dot_dia.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _IP, _I, _P]
    lib.cg_spmv_dot_dia.restype = _I
    lib.cg_spmm_dia.argtypes = [_I, _I, _P, _P, _P, _I, ctypes.c_longlong, _I, _IP, _I, _P]
    lib.cg_spmm_dia.restype = _I
    lib.cg_spmv_dia_split.argtypes = [_I, _P, _P, _P, _P, _P, _I, _I, _IP, _I, _I, _P]
    lib.cg_spmv_dia_split.restype = _I
    lib.cg_spmm_dia_split.argtypes = [_I, _I, _P, _P, _P, _I, ctypes.c_longlong, _I, _IP, _I, _I,
                                      _P]
    lib.cg_spmm_dia_split.restype = _I
    lib.cg_spmv_dia_batched.argtypes = [_I, _I, _P, ctypes.c_longlong, _P, _P, _P, _P, _I, _I,
                                        _IP, _I, _I, _P]
    lib.cg_spmv_dia_batched.restype = _I
    lib.cg_spmm_dia_acc.argtypes = [_I, _I, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _IP, _IP,
                                    _IP, _P]
    lib.cg_spmm_dia_acc.restype = _I
    lib.cg_spmm_dia_acc_tile.argtypes = []
    lib.cg_spmm_dia_acc_tile.restype = _I
    lib.cg_spmm_dia_acc_stages.argtypes = []
    lib.cg_spmm_dia_acc_stages.restype = _I


class NoHostCompiler(RuntimeError):
    """``$CXX`` is unset and no ``g++`` is on the path."""


def _cxx() -> str:
    cxx = os.environ.get("CXX")
    if cxx:
        return cxx
    if shutil.which("g++") is None:
        raise NoHostCompiler("no host C++ compiler: set CXX or put g++ on PATH")
    return "g++"


def host_library_path(name: str, extra: Tuple[str, ...] = ()) -> Path:
    """Where ``build_host`` puts the library of a host source built with
    ``extra`` flags: keyed on a hash of the compiler, its flags and the
    source."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS + extra).encode())
    h.update(HOST_SOURCES[name].read_bytes())
    return BUILD_DIR / f"libcg_{name}_{h.hexdigest()[:16]}.so"


def _compile_host(name: str, extra: Tuple[str, ...]) -> Tuple[Path, str]:
    """Compile ``name`` with ``extra`` flags unless a build of it exists:
    ``(library, "")``, or ``(library, the compiler's output)`` on a
    failure.  Each process writes its own temporary file and renames it
    into place, so processes that build at once (test workers) never load
    a partial library."""
    out = host_library_path(name, extra)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_cxx(), *CXX_FLAGS, *extra, "-o", str(tmp), str(HOST_SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler {cmd[0]!r} failed to start for {name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return out, f"{cmd[0]} exit {proc.returncode}:\n{(proc.stdout + proc.stderr)[-4000:]}"
    os.replace(tmp, out)
    return out, ""


def build_host(name: str) -> Path:
    """Compile the host C++ source ``name`` with its ``HOST_FLAGS`` unless a
    build of it exists, and without them where the compiler refuses them;
    the refusal is kept beside that library as ``.log``.  Raises
    ``NoHostCompiler`` when there is no compiler, ``RuntimeError`` when it
    fails to start or fails both ways."""
    extra = HOST_FLAGS.get(name, ())
    out, err = _compile_host(name, extra)
    if err and extra:
        out, err2 = _compile_host(name, ())
        if not err2:
            out.with_suffix(".log").write_text(f"refused {' '.join(extra)}: {err}\n")
        err = err2 and f"with {' '.join(extra)}: {err}\nwithout: {err2}"
    if err:
        raise RuntimeError(f"host build of {name} failed ({err})")
    return out


def _bind_csrkit(lib: ctypes.CDLL) -> None:
    i64, i32, f64 = ctypes.c_int64, ctypes.c_int32, ctypes.c_double
    lib.csrkit_coo_to_csr.argtypes = [i64, i64] + [_P] * 7
    lib.csrkit_coo_to_csr.restype = i64
    lib.csrkit_spmv.argtypes = [i64] + [_P] * 5
    lib.csrkit_spmv.restype = None
    lib.csrkit_halo_ranges.argtypes = [i64] + [_P] * 6
    lib.csrkit_halo_ranges.restype = None
    lib.csrkit_diag_census.argtypes = [i64, _P, _P, _P]
    lib.csrkit_diag_census.restype = i64
    lib.csrkit_csr_to_dia.argtypes = [i64, _P, _P, _P, i64, _P, _P]
    lib.csrkit_csr_to_dia.restype = i32
    lib.csrkit_csr_to_ell.argtypes = [i64, _P, _P, _P, i64, _P, _P]
    lib.csrkit_csr_to_ell.restype = i32
    lib.csrkit_banded_sin_dia.argtypes = [i64, i64, _P]
    lib.csrkit_banded_sin_dia.restype = None
    lib.csrkit_cg.argtypes = [i64] + [_P] * 5 + [f64, i32, i64, i64, ctypes.POINTER(f64)]
    lib.csrkit_cg.restype = i64
    lib.csrkit_version.argtypes = []
    lib.csrkit_version.restype = i32
    lib.csrkit_threads.argtypes = []
    lib.csrkit_threads.restype = i32
    lib.csrkit_aggregate.argtypes = [i64, _P, _P, _P, _P]
    lib.csrkit_aggregate.restype = i64


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of a host source, built first if needed (once
    per process)."""
    lib = ctypes.CDLL(str(build_host(name)))
    _HOST_BIND[name](lib)
    return lib


_BIND = {"stencil": _bind_stencil, "stencil_var": _bind_stencil_var, "dia": _bind_dia}
_HOST_BIND = {"csrkit": _bind_csrkit}


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed (once per
    process)."""
    lib = ctypes.CDLL(str(build([name], defines)[name]))
    lib.cg_error_string.argtypes = [_I]
    lib.cg_error_string.restype = ctypes.c_char_p
    _BIND[name](lib)
    return lib
