"""Build ``csrc/stencil.cu`` at first use and load it with ctypes.

The library is compiled by ``nvcc`` from the package's own sources into
``conjugategradient_tpu_torch/_build/``, under a name keyed on a hash of the
sources and flags, so a fresh checkout builds it on the first kernel launch
and an edited source rebuilds it.  The C interface takes plain pointers and
the stream as ``void*``; every pointer argument is declared ``c_void_p`` so
ctypes does not cut it to 32 bits.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCES = (_PKG / "csrc" / "stencil.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libcg_stencil_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless a build of the current sources exists;
    ``nvcc``'s output (including ``-Xptxas -v``) is kept beside it as
    ``.log``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)],
        capture_output=True, text=True,
    )
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with {proc.returncode}:\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees a partial file
    return out


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    lib = ctypes.CDLL(str(build()))
    lib.cg_error_string.argtypes = [_I]
    lib.cg_error_string.restype = ctypes.c_char_p
    lib.cg_spmv_const.argtypes = [_P, _P, _I, _I, _I, _I, _FP, _IP, _P]
    lib.cg_spmv_const.restype = _I
    lib.cg_cheb_const.argtypes = [
        _P, _P, _P, _P, _P, _I, _I, _I, _I, _FP, _IP, _I, _I,
        ctypes.c_float, _FP, _FP, _P,
    ]
    lib.cg_cheb_const.restype = _I
    return lib
