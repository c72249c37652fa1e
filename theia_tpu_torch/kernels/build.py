"""Build the port's CUDA kernels with nvcc and load them with ctypes.

All sources under ``theia_tpu_torch/csrc`` compile into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):
one nvcc process per source, all started together, then one link.
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
SOURCES = tuple(PACKAGE_DIR / "csrc" / name
                for name in ("mha_fwd.cu", "mha_bwd.cu", "flash_attn.cu", "ln_bwd.cu", "fused_loss.cu"))
HEADERS = tuple(PACKAGE_DIR / "csrc" / name for name in ("div_rn.cuh", "mma_bf16.cuh", "mma_tf32.cuh", "wgmma_bf16.cuh"))
BUILD_DIR = PACKAGE_DIR / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH_FLAGS,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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
    for src in SOURCES + HEADERS:
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libtheia_kernels_{digest.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails, else return their output."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(cmd)}\n{out}")
    return "".join(outs)


def build() -> Path:
    """Compile the sources unless a library for their current hash exists.

    Each source compiles to an object in its own nvcc process (all at once),
    then one nvcc links the library into a temporary file that is renamed
    into place, so processes that build at the same time never load a
    half-written library. The compiler's output (ptxas resource usage) goes
    to ``<library>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        objs = [str(Path(work) / f"{src.stem}.o") for src in SOURCES]
        log = _run([[nvcc_path(), *NVCC_FLAGS, "-c", str(src), "-o", obj] for src, obj in zip(SOURCES, objs)])
        tmp = str(Path(work) / out.name)
        log += _run([[nvcc_path(), *ARCH_FLAGS, "-shared", "-o", tmp, *objs]])
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)
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
            lib.theia_mha_fwd_bf16_blocks_per_sm.argtypes = [i32, i32]
            lib.theia_mha_fwd_bf16_blocks_per_sm.restype = i32
            lib.theia_mha_fwd_f32_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.theia_mha_fwd_f32_blocks_per_sm.restype = i32
            lib.theia_mha_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 6 + [i32, ctypes.c_float, ptr]
            lib.theia_mha_bwd.restype = i32
            lib.theia_mha_bwd_f32_blocks_per_sm.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
            lib.theia_mha_bwd_f32_blocks_per_sm.restype = i32
            lib.theia_mha_bwd_bf16_blocks_per_sm.argtypes = [i32, i32, i32, ctypes.POINTER(i32)]
            lib.theia_mha_bwd_bf16_blocks_per_sm.restype = i32
            lib.theia_flash_fwd.argtypes = [ptr] * 5 + [i32] * 4 + [i64] * 4 + [i32, ctypes.c_float, ptr]
            lib.theia_flash_fwd.restype = i32
            lib.theia_flash_dq.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 8 + [i32, ctypes.c_float, ptr]
            lib.theia_flash_dq.restype = i32
            lib.theia_flash_dkv.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 6 + [i32, ctypes.c_float, ptr]
            lib.theia_flash_dkv.restype = i32
            lib.theia_flash_f32_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.theia_flash_f32_blocks_per_sm.restype = i32
            lib.theia_flash_fwd_bf16_blocks_per_sm.argtypes = [i32, ctypes.POINTER(i32)]
            lib.theia_flash_fwd_bf16_blocks_per_sm.restype = i32
            lib.theia_flash_bwd_bf16_blocks_per_sm.argtypes = [i32, i32, ctypes.POINTER(i32)]
            lib.theia_flash_bwd_bf16_blocks_per_sm.restype = i32
            lib.theia_ln_bwd_stats_parts.argtypes = [i32] * 3
            lib.theia_ln_bwd_stats_parts.restype = i32
            lib.theia_ln_bwd_stats_counter_words.argtypes = []
            lib.theia_ln_bwd_stats_counter_words.restype = i32
            lib.theia_ln_bwd_stats.argtypes = [ptr] * 10 + [i32] * 4 + [ptr]
            lib.theia_ln_bwd_stats.restype = i32
            lib.theia_ln_bwd_stats_blocks_per_sm.argtypes = [i32] * 3 + [ctypes.POINTER(i32)] * 2
            lib.theia_ln_bwd_stats_blocks_per_sm.restype = i32
            lib.theia_ln_bwd_dx.argtypes = [ptr] * 8 + [i32, i64, i32, ptr]
            lib.theia_ln_bwd_dx.restype = i32
            lib.theia_loss_sums_partials.argtypes = [i64]
            lib.theia_loss_sums_partials.restype = i32
            lib.theia_loss_sums_fwd.argtypes = [ptr] * 4 + [i32, i64, i32, i32, ctypes.c_float, ptr]
            lib.theia_loss_sums_fwd.restype = i32
            lib.theia_loss_sums_bwd.argtypes = [ptr] * 4 + [i32, i64, i32, i32, ctypes.c_float, ptr]
            lib.theia_loss_sums_bwd.restype = i32
            lib.theia_cuda_error_string.argtypes = [i32]
            lib.theia_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib
