"""The native tar-header walker (``_fastpack.cpp``), built with g++ and loaded with ctypes.

Host code, the counterpart of ``theia_tpu/data/fastpack.py``'s
``tar_index``: one C loop walks every 512-byte header of a mapped shard,
where ``tarfile`` builds one Python ``TarInfo`` a member. Nothing happens at
import: the first :func:`tar_index` builds the library with ``g++ -O3
-shared -fPIC`` into ``theia_tpu_torch/_build/`` under a name that carries a
hash of the source and the flags, writing a per-process temporary file that
is renamed into place, since loader worker processes may race to build it.

Where no C++ compiler is on ``PATH`` (and no library for the current hash
exists), :func:`tar_index` returns None and the caller walks with
``tarfile``, as the JAX package does without one. Where a compiler is found
and the build or the load fails, it raises with the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "_fastpack.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libfastpack_{digest.hexdigest()[:16]}.so"


def build() -> Optional[Path]:
    """The library for the current source, built unless it exists; None
    when it does not exist and no C++ compiler is on ``PATH``."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load() -> Optional[ctypes.CDLL]:
    """Build if needed, load once per process and declare the C signature;
    None where :func:`build` finds no compiler."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            if path is None:
                return None
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"cannot load the tar indexer {path}: {e}") from e
            lib.fp_tar_index.restype = ctypes.c_int64
            lib.fp_tar_index.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ]
            _lib = lib
        return _lib


def tar_index(buf: Any) -> Optional[np.ndarray]:
    """[(header_off, data_off, size)] of the regular-file members of a tar
    held in ``buf`` (bytes, memoryview or mmap), int64 [n, 3]; None where
    no compiler is found, or where a member's size field is malformed (the
    caller's ``tarfile`` walk then reports the archive)."""
    lib = load()
    if lib is None:
        return None
    view = np.frombuffer(buf, np.uint8)  # held until the call returns: the pointer is into it
    n = view.size
    cap = max(n // 512, 16)
    out = np.empty((cap, 3), np.int64)
    got = lib.fp_tar_index(view.ctypes.data, n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap)
    if got < 0:
        return None
    return out[:got].copy()
