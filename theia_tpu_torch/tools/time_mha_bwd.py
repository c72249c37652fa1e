"""Time an attention kernel on one GPU against its plain version, SDPA and
other builds of its source: the whole-row forward K1 (``csrc/mha_fwd.cu``,
float32), the backward K2 (``csrc/mha_bwd.cu``, float32 or bf16), the flash
forward K7 (``csrc/flash_attn.cu``, float32 or bf16) or the flash backward
pair K9 + K8 (``csrc/flash_attn.cu``, float32 or bf16).

    python -m theia_tpu_torch.tools.time_mha_bwd [--kernel mha_fwd|mha_bwd|flash_fwd|flash_bwd]
        [--dtype float32|bfloat16] [--parent DIR] [--ablations] [--hd HD ...]

Builds the kernels (``kernels/build.py``) and prints ptxas's registers and
spills of the kernel's passes in that dtype at hd = 64 (and any wgmma it
serialized) and their resident blocks per SM. ``--parent DIR`` also builds
the same source of an unpacked earlier tree in DIR; ``--ablations`` builds
the source once for each entry of the kernel's ``ablations``, each undoing
one choice of the kernel through the ``-D`` settings its source reads. The
extra libraries build in parallel. Every build is held to the plain version
at the check shapes (a shape the earlier tree's kernel refuses to launch,
as K1 float32 did past its shared memory, is reported and skipped for that
build alone) (float32: max abs error within 2e-5, on each output:
K7's O and lse; bf16: relative L2 below 1e-2, K7's lse within 1e-5), then
all are timed at the timing shapes (12 heads of ``--hd``, 64 by default,
each head dim given) as views of a packed projection, with
SDPA (float32: its memory-efficient forward or backward; bf16: its flash
kernels) and the plain version, in the order a, b, ..., b, a (device time,
the stream held while the host enqueues), twice after a round that warms the
card; then each build's device time by kernel (its passes; torch.profiler).
Exits nonzero without a card or on a disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import math
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable

import torch

from theia_tpu_torch.kernels import build
from theia_tpu_torch.ops import attention
from theia_tpu_torch.tools.timing import (build_libraries, interleaved_ms, kernel_ms, ptxas_usage, sdpa_backward,
                                          sdpa_forward, wgmma_serialized)

F32_ATOL = 2e-5
BF16_REL_L2 = 1e-2  # P and dS round to bf16 before their products; a rounding may land either side
LSE_REL_L2 = 1e-5  # K7's lse: float32 row statistics whatever the inputs' dtype
H, HD = 12, 64
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@dataclasses.dataclass(frozen=True)
class Target:
    source: str  # under theia_tpu_torch/csrc
    passes: tuple[str, ...]  # ptxas names of its kernels in its dtype (the parent's where they differ)
    numbers: tuple[int, ...]  # the K numbers of its float32 flash kernels, for their occupancy query
    ablations: dict[str, tuple[str, ...]]  # name -> the -D settings it builds with
    checks: tuple[tuple[int, int, int], ...]  # (B, T, hd) held to the plain version, H = 2 where B = 2
    timed: tuple[tuple[int, int], ...]  # (B, T) timed at [B, T, 12, 64]
    signatures: dict[str, list]  # C function -> argtypes
    launcher: Callable  # lib -> fn(*inputs) -> what main returns
    main: Callable  # the port's wrapper: fn(*inputs)
    plain: Callable
    inputs: Callable  # (q, k, v, do) -> the arguments of the three above
    library: Callable  # (q, k, v, do) -> one PyTorch call for the same function, of no arguments
    dtype: torch.dtype = torch.float32


def _strides(*xs):
    return [s for x in xs for s in attention._outer_strides(x)]


def _grads(q):
    b, t, h, hd = q.shape
    grads = torch.empty((b, t, 3, h, hd), dtype=q.dtype, device=q.device)
    return grads, grads.unbind(2)


def mha_fwd_launcher(lib: ctypes.CDLL):
    """K1 through another build of the library (no checks), in q's dtype."""
    def run(q, k, v):
        b, t, h, hd = q.shape
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        err = lib.theia_mha_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, t, hd, *_strides(q, o),
                                attention._DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return o
    return run


def mha_launcher(lib: ctypes.CDLL):
    """mha_bwd through another build of the library (no checks), in q's dtype."""
    def run(q, k, v, do):
        b, t, h, hd = q.shape
        grads, (dq, dk, dv) = _grads(q)
        stats = torch.empty((b * h, 3, t), dtype=torch.float32, device=q.device)
        err = lib.theia_mha_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(),
                                dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), b, h, t, hd, *_strides(q, do, dq),
                                attention._DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
                                torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return grads
    return run


def flash_fwd_launcher(lib: ctypes.CDLL):
    """K7 through another build of the library (no checks): O and lse."""
    def run(q, k, v):
        b, t, h, hd = q.shape
        o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
        err = lib.theia_flash_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b, h, t, hd,
                                  *_strides(q, o), attention._DTYPE_CODES[q.dtype], 1.0 / math.sqrt(hd),
                                  torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return o, lse
    return run


def flash_launcher(lib: ctypes.CDLL):
    """K9 then K8 through another build of the library (no checks)."""
    def run(q, k, v, o, lse, do):
        b, t, h, hd = q.shape
        grads, (dq, dk, dv) = _grads(q)
        di = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
        scale, stream = 1.0 / math.sqrt(hd), torch.cuda.current_stream().cuda_stream
        err = lib.theia_flash_dq(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                                 lse.data_ptr(), di.data_ptr(), dq.data_ptr(), b, h, t, hd, *_strides(q, o, do, dq),
                                 attention._DTYPE_CODES[q.dtype], scale, stream)
        err = err or lib.theia_flash_dkv(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                                         di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, t, hd,
                                         *_strides(q, do, dk), attention._DTYPE_CODES[q.dtype], scale, stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return grads
    return run


TARGETS = {
    # float32 K1 (3xTF32); the parent's is the CUDA-core kernel of the same
    # name, no template
    "mha_fwd": Target(
        source="mha_fwd.cu",
        passes=(f"mha_fwd_f32<{HD}>", "mha_fwd_f32"),
        numbers=(),
        ablations={
            "split4": ("THEIA_K1_F32_SPLIT=4",),
            "warps8": ("THEIA_K1_F32_WARPS=8",),
            "restage": ("THEIA_K1_F32_RESTAGE=1",),
            "group1": ("THEIA_K1_F32_GROUP=1",),
            "div": ("THEIA_K1_F32_DIV_RN=0",),
            "cvt_rna": ("THEIA_TF32_CVT_RNA",),
        },
        checks=((64, 197, HD), (16, 204, HD),
                *((2, t, hd) for hd in (16, 64, 80, 128) for t in (1, 15, 16, 17, 63, 64, 65, 129, 197, 256))),
        timed=((64, 197), (16, 197)),
        signatures={"theia_mha_fwd": [PTR] * 4 + [I32] * 4 + [I64] * 4 + [I32, ctypes.c_float, PTR]},
        launcher=mha_fwd_launcher,
        main=attention.mha_fwd,
        plain=attention.mha_fwd_plain,
        inputs=lambda q, k, v, do: (q, k, v),
        library=lambda q, k, v, do: sdpa_forward(q, k, v),
    ),
    "mha_bwd": Target(
        source="mha_bwd.cu",
        passes=(f"mha_bwd_rows_f32<{HD}>", f"mha_bwd_cols_f32<{HD}>"),
        numbers=(),
        ablations={
            "rows_split1_warps4": ("THEIA_K2_ROW_SPLIT=1", "THEIA_K2_ROW_WARPS=4"),
            "rows_split2_warps8": ("THEIA_K2_ROW_SPLIT=2", "THEIA_K2_ROW_WARPS=8"),
            "rows_warps8": ("THEIA_K2_ROW_WARPS=8",),
            "cvt_rna": ("THEIA_TF32_CVT_RNA",),
        },
        checks=((16, 197, HD), (2, 17, HD), (2, 65, HD), (2, 256, HD)),
        timed=((16, 197),),
        signatures={"theia_mha_bwd": [PTR] * 8 + [I32] * 4 + [I64] * 6 + [I32, ctypes.c_float, PTR]},
        launcher=mha_launcher,
        main=attention.mha_bwd,
        plain=attention.mha_bwd_plain,
        inputs=lambda q, k, v, do: (q, k, v, do),
        library=sdpa_backward,
    ),
    "flash_fwd": Target(
        source="flash_attn.cu",
        passes=(f"flash_fwd_f32<{HD}>", "flash_fwd_f32"),
        numbers=(7,),
        ablations={
            "split1": ("THEIA_FLASH_F32_SPLIT=1",),
            "shared_max": ("THEIA_FLASH_FWD_F32_SHARED_MAX=1",),
            "held_a": ("THEIA_FLASH_F32_HELD_A=1",),
            "cvt_rna": ("THEIA_TF32_CVT_RNA",),
        },
        checks=((64, 197, HD), (16, 785, HD),
                *((2, t, hd) for hd in (16, 64, 80, 128) for t in (1, 15, 16, 17, 63, 64, 65, 130, 197))),
        timed=((64, 197), (16, 785)),
        signatures={"theia_flash_fwd": [PTR] * 5 + [I32] * 4 + [I64] * 4 + [I32, ctypes.c_float, PTR]},
        launcher=flash_fwd_launcher,
        main=attention.flash_fwd,
        plain=attention.flash_fwd_plain,
        inputs=lambda q, k, v, do: (q, k, v),
        library=lambda q, k, v, do: sdpa_forward(q, k, v),
    ),
    "flash_bwd": Target(
        source="flash_attn.cu",
        passes=(f"flash_dq_f32<{HD}>", f"flash_dkv_f32<{HD}>", "flash_dq_f32", "flash_dkv_f32"),
        numbers=(9, 8),
        ablations={
            "split1": ("THEIA_FLASH_F32_SPLIT=1",),
            "held_a": ("THEIA_FLASH_F32_HELD_A=1",),
            "split1_held_a": ("THEIA_FLASH_F32_SPLIT=1", "THEIA_FLASH_F32_HELD_A=1"),
            "cvt_rna": ("THEIA_TF32_CVT_RNA",),
        },
        checks=((16, 197, HD), (16, 785, HD),
                *((2, t, hd) for hd in (16, 64, 80, 128) for t in (1, 15, 16, 17, 63, 64, 65, 130, 197))),
        timed=((16, 197), (16, 785)),
        signatures={"theia_flash_dq": [PTR] * 8 + [I32] * 4 + [I64] * 8 + [I32, ctypes.c_float, PTR],
                    "theia_flash_dkv": [PTR] * 8 + [I32] * 4 + [I64] * 6 + [I32, ctypes.c_float, PTR]},
        launcher=flash_launcher,
        main=attention.flash_bwd,
        plain=attention.flash_bwd_plain,
        inputs=lambda q, k, v, do: (q, k, v, *attention.flash_fwd(q, k, v), do),  # K7's O and lse
        library=sdpa_backward,
    ),
}


# bf16 K2 (the two wgmma passes); its row pass is <hd, chunks of 64 keys a
# warpgroup>: 2 at T = 197 with 2 warpgroups a block, 1 with 4 (the
# row_split4 ablation); the parent's passes are <hd> alone
BF16_TARGETS = {
    "mha_bwd": dataclasses.replace(
        TARGETS["mha_bwd"],
        passes=(f"mha_bwd_rows_bf16<{HD},2>", f"mha_bwd_rows_bf16<{HD},1>", f"mha_bwd_cols_bf16<{HD}>",
                f"mha_bwd_rows_bf16<{HD}>"),
        ablations={
            "row_split4": ("THEIA_K2_BF16_ROW_SPLIT=4",),
            "col_n64": ("THEIA_K2_BF16_COL_N=64",),
            "col_wg1": ("THEIA_K2_BF16_COL_WG=1",),
        },
        checks=((16, 197, HD), (16, 204, HD), (1, 197, HD),
                *((2, t, hd) for hd in (16, 32, 64, 80, 128) for t in (1, 17, 63, 64, 65, 128, 129, 193, 256))),
        dtype=torch.bfloat16,
    ),
    # bf16 K7 (wgmma); the parent's is the mma.sync kernel of the same name
    "flash_fwd": dataclasses.replace(
        TARGETS["flash_fwd"],
        passes=(f"flash_fwd_bf16<{HD}>",),
        numbers=(),
        ablations={
            "wg1": ("THEIA_K7_BF16_WG=1",),
            "stages2": ("THEIA_K7_BF16_STAGES=2",),
            "pipe0": ("THEIA_K7_BF16_PIPE=0",),
        },
        checks=((64, 197, HD), (16, 785, HD),
                *((2, t, hd) for hd in (16, 64, 80, 128) for t in (1, 17, 64, 65, 127, 128, 129, 257))),
        dtype=torch.bfloat16,
    ),
    # bf16 K9 + K8 (wgmma); the parent's are the mma.sync kernels of the same names
    "flash_bwd": dataclasses.replace(
        TARGETS["flash_bwd"],
        passes=(f"flash_dq_bf16<{HD}>", f"flash_dkv_bf16<{HD}>", "flash_dq_bf16<128>", "flash_dkv_bf16<128>"),
        numbers=(9, 8),
        ablations={
            "k9_wg2": ("THEIA_K9_BF16_WG=2",),
            "k8_wg2": ("THEIA_K8_BF16_WG=2",),
            "k9_stages3": ("THEIA_K9_BF16_STAGES=3",),
            "k8_n64": ("THEIA_K8_BF16_N=64",),
            "k8_stages2": ("THEIA_K8_BF16_STAGES=2",),
        },
        checks=((16, 197, HD), (16, 785, HD),
                *((2, t, hd) for hd in (16, 64, 80, 128) for t in (1, 17, 63, 64, 65, 127, 128, 129, 257))),
        dtype=torch.bfloat16,
    ),
}


def print_ptxas(target: Target, name: str, log: str) -> None:
    """ptxas's registers and spills of the target's kernels in a build's log, and any wgmma it serialized."""
    usage = dict(ptxas_usage(log))
    serialized = wgmma_serialized(log)
    for kernel in target.passes:
        if kernel in usage:
            notes = "; ".join(reason for k, reason in serialized if k == kernel)
            print(f"  {name}: ptxas {kernel}: {usage[kernel]}" + (f"; wgmma serialized ({notes})" if notes else ""))


def print_occupancy(kernel: str, dtype: torch.dtype, lib: ctypes.CDLL) -> None:
    """Resident blocks per SM of the port's passes at hd = 64 in ``dtype``."""
    threads = ctypes.c_int(0)
    if kernel == "mha_fwd":
        t = 197
        blocks = lib.theia_mha_fwd_f32_blocks_per_sm(t, HD, ctypes.byref(threads))
        print(f"  kernel: mha_fwd_f32<{HD}> at T = {t}: {blocks} resident blocks per SM of {threads.value} threads")
    elif kernel == "mha_bwd":
        t = 197
        query = lib.theia_mha_bwd_bf16_blocks_per_sm if dtype == torch.bfloat16 else lib.theia_mha_bwd_f32_blocks_per_sm
        for cols, name in enumerate(("row pass", "column pass")):
            blocks = query(t, HD, cols, ctypes.byref(threads))
            print(f"  kernel: {name} at T = {t}: {blocks} resident blocks per SM of {threads.value} threads")
    elif dtype == torch.bfloat16 and kernel == "flash_fwd":
        blocks = lib.theia_flash_fwd_bf16_blocks_per_sm(HD, ctypes.byref(threads))
        print(f"  kernel: flash_fwd_bf16<{HD}>: {blocks} resident blocks per SM of {threads.value} threads")
    elif dtype == torch.bfloat16:  # K9 and K8
        for number, name in zip(BF16_TARGETS[kernel].numbers, BF16_TARGETS[kernel].passes):
            blocks = lib.theia_flash_bwd_bf16_blocks_per_sm(HD, number, ctypes.byref(threads))
            print(f"  kernel: {name}: {blocks} resident blocks per SM of {threads.value} threads")
    else:
        for number, name in zip(TARGETS[kernel].numbers, TARGETS[kernel].passes):
            blocks = lib.theia_flash_f32_blocks_per_sm(HD, number, ctypes.byref(threads))
            print(f"  kernel: {name}: {blocks} resident blocks per SM of {threads.value} threads")


def error(got, want, dtype: torch.dtype) -> tuple[float, ...]:
    """float32: the largest abs error over an output, or over each of a
    tuple of them (O and lse), as one number; bf16: each output's relative
    L2 error (O, then lse), or its largest abs error where the plain result
    is 0."""
    pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
    if dtype == torch.bfloat16:
        out = []
        for g, w in pairs:
            g, w = g.double(), w.double()
            norm = float(w.norm())
            out.append(float((g - w).norm()) / norm if norm else float((g - w).abs().max()))
        return tuple(out)
    return (max(float((g - w).abs().max()) for g, w in pairs),)


def within(errs: tuple[float, ...], dtype: torch.dtype) -> bool:
    """float32: within F32_ATOL; bf16: the first output within BF16_REL_L2, K7's lse within LSE_REL_L2."""
    if dtype == torch.bfloat16:
        return errs[0] < BF16_REL_L2 and all(e <= LSE_REL_L2 for e in errs[1:])
    return errs[0] <= F32_ATOL


def shown(errs: tuple[float, ...]) -> str:
    return "/".join(f"{e:.2e}" for e in errs)


def packed(b: int, t: int, h: int, hd: int, gen: torch.Generator, dtype: torch.dtype) -> tuple[torch.Tensor, ...]:
    qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=gen).to(dtype)
    q, k, v = (y.view(b, t, h, hd) for y in qkv.split(h * hd, dim=-1))
    return q, k, v, torch.randn(b, t, h, hd, device="cuda", generator=gen).to(dtype)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(TARGETS), default="mha_bwd",
                        help="K1 (mha_fwd), K2 (mha_bwd), the flash forward K7 (flash_fwd) or the flash pair K9 + K8 "
                             "(flash_bwd)")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                        help="the kernel's inputs; bfloat16 for --kernel mha_bwd, flash_fwd or flash_bwd")
    parser.add_argument("--parent", type=Path, help="an unpacked earlier tree whose source of the kernel to time too")
    parser.add_argument("--ablations", action="store_true", help="also time the builds of the kernel's ablations")
    parser.add_argument("--hd", type=int, nargs="+", default=[HD], help="head dims of the timed shapes")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_mha_bwd: no CUDA device", file=sys.stderr)
        return 1
    targets = BF16_TARGETS if args.dtype == "bfloat16" else TARGETS
    if args.kernel not in targets:
        parser.error(f"--kernel {args.kernel} times float32 only")
    target = targets[args.kernel]
    dtype = target.dtype
    limit = f"{BF16_REL_L2}, lse {LSE_REL_L2}" if dtype == torch.bfloat16 else F32_ATOL
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = build.build()
    print_ptxas(target, "kernel", lib_path.with_suffix(".log").read_text())
    print_occupancy(args.kernel, dtype, build.load())
    sources = {}
    if args.parent:
        sources["parent"] = (args.parent / "theia_tpu_torch" / "csrc" / target.source, (), target.signatures)
    if args.ablations:
        sources.update({name: (build.PACKAGE_DIR / "csrc" / target.source, d, target.signatures)
                        for name, d in target.ablations.items()})
    fns = {"kernel": target.main}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        libs = build_libraries(sources, Path(work), lambda name, log: print_ptxas(target, name, log))
        fns.update({name: target.launcher(lib) for name, lib in libs.items()})
        gen = torch.Generator(device="cuda").manual_seed(0)
        worst = {}
        metric = "relative L2 error (O/lse for K7)" if dtype == torch.bfloat16 else "max abs error"
        for b, t, hd in target.checks:
            q, k, v, do = packed(b, t, H if b > 2 else 2, hd, gen, dtype)
            inputs = target.inputs(q, k, v, do)
            want = target.plain(*inputs)
            errs = {}
            for name, fn in fns.items():
                try:
                    errs[name] = error(fn(*inputs), want, dtype)
                except RuntimeError as exc:
                    if name != "parent":
                        raise
                    print(f"  [{b},{t},{q.shape[2]},{hd}] parent: {exc}; not held there")
            worst = {name: tuple(map(max, zip(worst.get(name, e), e))) for name, e in errs.items()}
            if hd == HD and b > 2 or not all(within(e, dtype) for e in errs.values()):
                print(f"  [{b},{t},{q.shape[2]},{hd}] {metric} against the plain version: "
                      + ", ".join(f"{n} {shown(e)}" for n, e in errs.items()))
            bad = [n for n, e in errs.items() if not within(e, dtype)]
            if bad:
                print(f"time_mha_bwd: {bad} disagree with the plain version (limit {limit})", file=sys.stderr)
                return 1
        print(f"  worst {metric} over the {len(target.checks)} check shapes: "
              + ", ".join(f"{n} {shown(e)}" for n, e in worst.items()))
        for (b, t), hd in ((shape, hd) for hd in args.hd for shape in target.timed):
            q, k, v, do = packed(b, t, H, hd, gen, dtype)
            inputs = target.inputs(q, k, v, do)
            timed = {name: (lambda fn=fn: fn(*inputs)) for name, fn in fns.items()}
            timed["plain"] = lambda: target.plain(*inputs)
            timed["sdpa"] = target.library(q, k, v, do)
            for rep in range(3):  # the first round warms the card and is not printed
                ms = interleaved_ms(timed)
                if rep:
                    print(f"  [{b},{t},{H},{hd}] {args.dtype}, device ms (order a..b..a, {card}): "
                          + ", ".join(f"{n} {v:.4f}" for n, v in ms.items()))
            for name in fns:
                split = kernel_ms(timed[name])
                print(f"  [{b},{t},{H},{hd}] {name}, device ms a call by kernel (torch.profiler, 50 calls): "
                      + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
