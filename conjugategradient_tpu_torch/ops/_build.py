"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each source (``stencil.cu``, ``stencil_var.cu``, ``dia.cu``) becomes its
own shared library, compiled by ``nvcc`` from the package's own sources into
``conjugategradient_tpu_torch/_build/`` under a name keyed on a hash of that
source and the flags, so a fresh checkout builds it on the first kernel
launch and an edited source rebuilds it.  ``build()`` starts one ``nvcc`` per
missing library, all together, and waits for them.  The C interfaces take
plain pointers and the stream as ``void*``; every pointer argument is
declared ``c_void_p`` so ctypes does not cut it to 32 bits.

The host C++ sources (``aggregate.cpp``, the AMG setup's greedy
aggregation) build the same way with the host compiler (``$CXX``, else
``g++``), which the CPU machines have too: ``build_host`` / ``load_host``.
A failed build raises; nothing falls back.
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
HOST_SOURCES = {"aggregate": _PKG / "csrc" / "aggregate.cpp"}
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
    lib.cg_spmm_dia_acc.argtypes = [_I, _I, _P, _P, _P, _I, ctypes.c_longlong, _I, _I, _IP, _IP,
                                    _IP, _P]
    lib.cg_spmm_dia_acc.restype = _I
    lib.cg_spmm_dia_acc_tile.argtypes = []
    lib.cg_spmm_dia_acc_tile.restype = _I
    lib.cg_spmm_dia_acc_stages.argtypes = []
    lib.cg_spmm_dia_acc_stages.restype = _I


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def host_library_path(name: str) -> Path:
    """Where ``build_host`` puts the library of a host source: keyed on a
    hash of the compiler, its flags and the source."""
    h = hashlib.sha256(" ".join((_cxx(),) + CXX_FLAGS).encode())
    h.update(HOST_SOURCES[name].read_bytes())
    return BUILD_DIR / f"libcg_{name}_{h.hexdigest()[:16]}.so"


def build_host(name: str) -> Path:
    """Compile the host C++ source ``name`` unless a build of it exists.
    Each process writes its own temporary file and renames it into place,
    so processes that build at once (test workers) never load a partial
    library.  Raises ``RuntimeError`` when the compiler is missing or
    fails."""
    out = host_library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(HOST_SOURCES[name])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"host compiler {cmd[0]!r} failed to start for {name}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cmd[0]} failed for {name} (exit {proc.returncode}):\n"
                           f"{(proc.stdout + proc.stderr)[-4000:]}")
    os.replace(tmp, out)
    return out


def _bind_aggregate(lib: ctypes.CDLL) -> None:
    lib.cg_aggregate.argtypes = [ctypes.c_int64, _P, _P, _P, _P]
    lib.cg_aggregate.restype = ctypes.c_int64


@functools.lru_cache(maxsize=None)
def load_host(name: str) -> ctypes.CDLL:
    """The loaded library of a host source, built first if needed (once
    per process)."""
    lib = ctypes.CDLL(str(build_host(name)))
    _HOST_BIND[name](lib)
    return lib


_BIND = {"stencil": _bind_stencil, "stencil_var": _bind_stencil_var, "dia": _bind_dia}
_HOST_BIND = {"aggregate": _bind_aggregate}


@functools.lru_cache(maxsize=None)
def load(name: str, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of one source, built first if needed (once per
    process)."""
    lib = ctypes.CDLL(str(build([name], defines)[name]))
    lib.cg_error_string.argtypes = [_I]
    lib.cg_error_string.restype = ctypes.c_char_p
    _BIND[name](lib)
    return lib
