"""Time K12, SAM's attention with decomposed relative-position bias (``csrc/relpos_attn.cu``), on one card.

    python -m theia_tpu_torch.tools.time_relpos_attn [--iters 10]

Builds the port's library and, from the same source, the ``-D`` variants in
``ABLATIONS``; prints ptxas's registers and spills of ``relpos_attn_f32<80>``
and its resident blocks a SM; then at SAM-H's two shapes at the extraction's
batch of 32 ([800, 196, 16, 80], the windows; [32, 4096, 16, 80], the global
layers) holds each build to the plain version ``ops/attention.py``
``relpos_attention_plain`` (rel L2) and times, in turns: the kernel alone on the
tables' products, ``relpos_attention`` whole (the two products and the
kernel), each variant's kernel, the plain version, and at the window shape
SDPA's memory-efficient forward with the bias as a materialised float mask
(at the global shape that mask would be 32 GiB). Each time is beside the
kernel's bound, max(bytes / 3.35 TB/s, FLOPs / 495 TFLOP/s TF32): q, k, v
read and o written once, 4 B H T² hd FLOPs. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import tempfile
from pathlib import Path

import torch

from theia_tpu_torch.kernels import build
from theia_tpu_torch.ops import attention
from theia_tpu_torch.tools import timing

SOURCE = build.PACKAGE_DIR / "csrc" / "relpos_attn.cu"
ABLATIONS = {"min_blocks1": ("THEIA_K12_MIN_BLOCKS=1",)}
SHAPES = {"windows": (800, 14), "global": (32, 64)}
HEADS, HD = 16, 80


def bound_ms(entries: int, side: int) -> float:
    t, c = side * side, HEADS * HD
    return 1e3 * max(4 * entries * t * c * 4 / 3.35e12, 4.0 * entries * HEADS * t * t * HD / 495e12)


def sdpa_with_mask(qkv: torch.Tensor, rh: torch.Tensor, rw: torch.Tensor, side: int):
    """A call of SDPA's forward with the decomposed bias as a materialised
    float mask [B, H, T, T] (``relpos_terms``, built once): the library's
    way to the same function."""
    b, t, c3 = qkv.shape
    qh, kh, vh = (y.view(b, t, HEADS, HD).transpose(1, 2) for y in qkv.split(c3 // 3, dim=-1))
    rel_h, rel_w = attention.relpos_terms(qh, rh, rw, side, side, qkv.dtype)
    bias = (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, HEADS, t, t)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return lambda: sdpa(qh, kh, vh, attn_mask=bias)


def ptxas(log: str) -> list[str]:
    """ptxas's lines for K12 in an nvcc log."""
    out, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = "relpos_attn" in line and "ILi80E" in line
        elif on and ("registers" in line or "spill" in line):
            out.append(line.strip())
    return out


def launcher(lib: ctypes.CDLL):
    """fn(qkv, ph, pw) -> o: the variant's K12 on ``relpos_tables``' products."""

    def run(qkv, ph, pw, side):
        b, t, c3 = qkv.shape
        q, k, v = attention._split_heads(qkv, HEADS)
        o = torch.empty((b, t, c3 // 3), device=qkv.device).view(b, t, HEADS, HD)
        err = lib.theia_relpos_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ph.data_ptr(), pw.data_ptr(),
                                    o.data_ptr(), b, HEADS, side, HD, *attention._outer_strides(q),
                                    *attention._outer_strides(o), ph.stride(0), t * ph.stride(1), ph.stride(1),
                                    ctypes.c_float(1.0 / math.sqrt(HD)),
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if err:
            raise RuntimeError(f"K12 variant launch failed: {err}")
        return o.view(b, t, c3 // 3)

    return run


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_relpos_attn: no CUDA device")
        return 2
    dev = torch.device("cuda")
    print(torch.cuda.get_device_name(0))
    lib = build.load()
    print("build", build.library_path().name)
    for line in ptxas(build.library_path().with_suffix(".log").read_text()):
        print("  ptxas relpos_attn_f32<80>:", line)
    threads = ctypes.c_int(0)
    print(f"  blocks a SM: {lib.theia_relpos_attn_blocks_per_sm(HD, ctypes.byref(threads))} of {threads.value} threads")
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    argtypes = {"theia_relpos_attn": [ptr] * 6 + [i32] * 4 + [i64] * 7 + [ctypes.c_float, ptr],
                "theia_relpos_attn_blocks_per_sm": [i32, ctypes.POINTER(i32)]}
    with tempfile.TemporaryDirectory() as work:
        def report(name, log):
            for line in ptxas(log):
                print(f"  ptxas {name}:", line)

        variants = timing.build_libraries({n: (SOURCE, d, argtypes) for n, d in ABLATIONS.items()}, Path(work), report)
        for name, vlib in variants.items():
            print(f"  {name} blocks a SM: {vlib.theia_relpos_attn_blocks_per_sm(HD, ctypes.byref(threads))}")
        runs = {"kernel": launcher(lib), **{n: launcher(v) for n, v in variants.items()}}
        gen = torch.Generator(device=dev).manual_seed(0)
        for shape, (entries, side) in SHAPES.items():
            qkv = 0.7 * torch.randn(entries, side * side, 3 * HEADS * HD, generator=gen, device=dev)
            rh = 0.1 * torch.randn(2 * side - 1, HD, generator=gen, device=dev)
            rw = 0.1 * torch.randn(2 * side - 1, HD, generator=gen, device=dev)
            q, k, v = qkv.split(HEADS * HD, dim=-1)
            with torch.no_grad():
                ph, pw = attention.relpos_tables(attention._split_heads(qkv, HEADS)[0], rh, rw)
                want = attention.relpos_attention_plain(q, k, v, rh, rw, HEADS, side, side, torch.float32)
                fns = {n: (lambda f=f: f(qkv, ph, pw, side)) for n, f in runs.items()}
                for n, fn in fns.items():
                    rel = float((fn().double() - want).norm() / want.norm())
                    print(f"[{entries}, {side * side}, {HEADS}, {HD}] {n}: rel L2 {rel:.3e}")
                fns["relpos_attention"] = lambda: attention.relpos_attention(qkv, rh, rw, HEADS, side)
                fns["plain"] = lambda: attention.relpos_attention_plain(q, k, v, rh, rw, HEADS, side, side,
                                                                        torch.float32)
                if shape == "windows":
                    fns["sdpa_mask"] = sdpa_with_mask(qkv, rh, rw, side)
                times = timing.interleaved_ms(fns, iters=args.iters, hold=False)
            for n, ms in times.items():
                print(f"[{entries}, {side * side}, {HEADS}, {HD}] {shape} {n}: {ms:.4f} ms "
                      f"(bound {bound_ms(entries, side):.4f}, {100 * bound_ms(entries, side) / ms:.1f}%)")
            del qkv, q, k, v, ph, pw, fns
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
