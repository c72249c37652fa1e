"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources under ``theia_tpu_torch/csrc`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in ``theia_tpu_torch/_build/`` under a name that carries a
hash of the sources and flags, so editing a source triggers a rebuild and a
stale library is never loaded. Nothing here runs at import time: the first
wrapper that receives a CUDA tensor calls :func:`load`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCES = (PACKAGE_DIR / "csrc" / "mha_fwd.cu",)
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills per kernel, kept in the build log
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    """nvcc under $CUDA_HOME, else on $PATH, else under the toolkit's default prefix."""
    if "CUDA_HOME" in os.environ:
        return str(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in SOURCES:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtheia_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for their current hash exists.

    Compiles into a temporary file and renames it into place, so processes
    that build at the same time never load a half-written library. The
    compiler's output (ptxas resource usage) goes to ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
            )
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.theia_mha_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i32, i64, i64, i64, i64, i32, ctypes.c_float, ptr]
            lib.theia_mha_fwd.restype = i32
            lib.theia_cuda_error_string.argtypes = [i32]
            lib.theia_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
