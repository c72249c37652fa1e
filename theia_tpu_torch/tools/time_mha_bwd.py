"""Time K2 float32, the attention backward (``csrc/mha_bwd.cu``), on one GPU
against its plain version, SDPA's backward and other builds of its source.

    python -m theia_tpu_torch.tools.time_mha_bwd [--parent DIR] [--ablations]

Builds the kernels (``kernels/build.py``) and prints ptxas's registers and
spills of the float32 passes at hd = 64 and their resident blocks per SM at
T = 197. ``--parent DIR`` also builds ``DIR/theia_tpu_torch/csrc/mha_bwd.cu``
(an unpacked earlier tree); ``--ablations`` builds ``csrc/mha_bwd.cu`` once
for each entry of ``ABLATIONS``, each undoing one choice of the kernel
through the ``-D`` settings its source reads. The extra libraries build in
parallel. Every build is held to ``mha_bwd_plain`` (max abs error within
2e-5) at [16, 197, 12, 64] and [2, 17 | 65 | 256, 12, 64], then all are
timed at [16, 197, 12, 64] as views of a packed projection, with SDPA's
memory-efficient backward and the plain version, in the order a, b, ...,
b, a (device time, the stream held while the host enqueues), twice after a
round that warms the card. Exits nonzero without a card or on a
disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from theia_tpu_torch.kernels import build
from theia_tpu_torch.ops import attention
from theia_tpu_torch.tools.timing import interleaved_ms, ptxas_usage, sdpa_backward

F32_ATOL = 2e-5
B, T, H, HD = 16, 197, 12, 64
PASSES = (f"mha_bwd_rows_f32<{HD}>", f"mha_bwd_cols_f32<{HD}>")
# name -> the -D settings of csrc/mha_bwd.cu and csrc/mma_tf32.cuh it builds with
ABLATIONS = {
    "rows_split1_warps4": ("THEIA_K2_ROW_SPLIT=1", "THEIA_K2_ROW_WARPS=4"),
    "rows_split2_warps8": ("THEIA_K2_ROW_SPLIT=2", "THEIA_K2_ROW_WARPS=8"),
    "rows_warps8": ("THEIA_K2_ROW_WARPS=8",),
    "cvt_rna": ("THEIA_TF32_CVT_RNA",),
}


def print_ptxas(name: str, log: str) -> None:
    usage = dict(ptxas_usage(log))
    for k2 in PASSES:
        print(f"  {name}: ptxas {k2}: {usage.get(k2)}")


def build_libraries(sources: dict[str, tuple[Path, tuple[str, ...]]], work: Path) -> dict[str, ctypes.CDLL]:
    """One shared library per (source, -D settings), nvcc processes in parallel."""
    procs = {}
    for name, (source, defines) in sources.items():
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
             str(work / f"lib{name}.so"), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        print_ptxas(name, log)
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        lib.theia_mha_bwd.argtypes = [ptr] * 8 + [i32] * 4 + [i64] * 6 + [i32, ctypes.c_float, ptr]
        lib.theia_mha_bwd.restype = i32
        libs[name] = lib
    return libs


def launcher(lib: ctypes.CDLL):
    """mha_bwd through another build of the library (no checks; views of a packed projection)."""
    def run(q, k, v, do):
        b, t, h, hd = q.shape
        grads = torch.empty((b, t, 3, h, hd), dtype=q.dtype, device=q.device)
        stats = torch.empty((b * h, 3, t), dtype=torch.float32, device=q.device)
        dq, dk, dv = grads.unbind(2)
        err = lib.theia_mha_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, t, hd,
                                *attention._outer_strides(q), *attention._outer_strides(do),
                                *attention._outer_strides(dq), 0, 1.0 / math.sqrt(hd),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return grads
    return run


def packed(b: int, t: int, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    qkv = torch.randn(b, t, 3 * H * HD, device="cuda", generator=gen)
    q, k, v = (y.view(b, t, H, HD) for y in qkv.split(H * HD, dim=-1))
    return q, k, v, torch.randn(b, t, H, HD, device="cuda", generator=gen)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="an unpacked earlier tree whose csrc/mha_bwd.cu to time too")
    parser.add_argument("--ablations", action="store_true", help="also time the builds of ABLATIONS")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_mha_bwd: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = build.build()
    lib = build.load()
    print_ptxas("kernel", lib_path.with_suffix(".log").read_text())
    for cols, k2 in enumerate(PASSES):
        threads = ctypes.c_int(0)
        blocks = lib.theia_mha_bwd_f32_blocks_per_sm(T, HD, cols, ctypes.byref(threads))
        print(f"  kernel: {k2} at T = {T}: {blocks} resident blocks per SM of {threads.value} threads")
    sources = {}
    if args.parent:
        sources["parent"] = (args.parent / "theia_tpu_torch" / "csrc" / "mha_bwd.cu", ())
    if args.ablations:
        sources.update({name: (build.PACKAGE_DIR / "csrc" / "mha_bwd.cu", d) for name, d in ABLATIONS.items()})
    fns = {"kernel": attention.mha_bwd}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        fns.update({name: launcher(l) for name, l in build_libraries(sources, Path(work)).items()})
        gen = torch.Generator(device="cuda").manual_seed(0)
        for b, t in ((B, T), (2, 17), (2, 65), (2, 256)):
            q, k, v, do = packed(b, t, gen)
            want = attention.mha_bwd_plain(q, k, v, do)
            errs = {name: float((fn(q, k, v, do) - want).abs().max()) for name, fn in fns.items()}
            print(f"  [{b},{t},{H},{HD}] max abs error against mha_bwd_plain: "
                  + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
            bad = [n for n, e in errs.items() if not e <= F32_ATOL]
            if bad:
                print(f"time_mha_bwd: {bad} disagree with mha_bwd_plain (atol {F32_ATOL})", file=sys.stderr)
                return 1
        q, k, v, do = packed(B, T, gen)
        timed = {name: (lambda fn=fn: fn(q, k, v, do)) for name, fn in fns.items()}
        timed["plain"] = lambda: attention.mha_bwd_plain(q, k, v, do)
        timed["sdpa"] = sdpa_backward(q, k, v, do)
        for rep in range(3):  # the first round warms the card and is not printed
            ms = interleaved_ms(timed)
            if rep:
                print(f"  [{B},{T},{H},{HD}] float32, device ms (order a..b..a, {card}): "
                      + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
