"""Time K3 and K4, the LayerNormSpatial backward's sums and dx
(``csrc/ln_bwd.cu``), on one GPU against their plain versions, one PyTorch
call and other builds of their source.

    python -m theia_tpu_torch.tools.time_ln_bwd [--kernel k3|k4|both] [--parent DIR] [--ablations]

Builds the kernels (``kernels/build.py``) and prints ptxas's registers and
spills of ``ln_bwd_stats_sm90`` and ``ln_bwd_dx_sm90`` (and K4's one-element
``ln_bwd_dx_scalar``) in bf16 and float32 and, at each timed shape, each
kernel's resident blocks a SM and its grid. ``--parent DIR`` also builds
``csrc/ln_bwd.cu`` of an unpacked earlier tree in DIR whose K3 is one launch
(``theia_ln_bwd_stats_parts``): its K3 is called through this tree's
launcher and must give bit-identical results; its K4 is called as its
wrapper called it, through this tree's (C, H, W) interface where it has
one (``theia_ln_bwd_dx_blocks_per_sm``), else on the weight permuted to
[S, C] by a copy before each call. ``--ablations`` builds the source once
for each entry of ``K3.ablations`` and ``K4.ablations``, each changing one
constant of a kernel through the ``-D`` switches the source reads. The
extra libraries build in parallel.

K3: every build is held to ``ln_bwd_stats_plain`` (relative L2 within 1e-5
on each of s1, s2, dw and db) at B x S x C in ``CHECKS`` in both dtypes and
at the timed shapes; the port's kernel must also give bit-identical results
on two calls and on 50 calls back to back. Then all are timed at ``TIMED``
with the plain version and ``native_layer_norm_backward``, in the order a,
b, ..., b, a (device time, the stream held while the host enqueues), twice
after a round that warms the card, with each one's share of its bound and
the step's sum over the recipe's 15 sites (11 at 16x16, 2 at 31x31, 2 at
64x64), and at the conv translator's widest shapes (``TIMED_WIDE``); then
each build's device time by kernel (torch.profiler).

K4: every build is held to ``ln_bwd_dx_plain`` in float64 (relative L2
1e-6 in float32, 1e-2 in bf16, its rounding) at ``DX_CHECKS`` (B not a
multiple of the batch split, S = 1, C = 8, 60, 768 and 2048, N twice the
row) in both dtypes; the port's kernel must give bit-identical results on
two calls, on 50 calls back to back, and one device operation a call at
``DX_OPS`` (torch.profiler). Then all are timed as K3 is at ``DX_TIMED``
(the recipe's sites, the conv translator's, a tensor-parallel rank's split
maps and the policy heads'), this tree's kernel both through its wrapper
and through the bare C call the other builds take, with the step's sum,
the kernel's and the parent's device time by kernel at three shapes, and a
summary of this tree's K4 against the parent's. Exits nonzero without a
card or on a disagreement.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Callable

import torch

from theia_tpu_torch.kernels import build
from theia_tpu_torch.ops import ln_pallas
from theia_tpu_torch.tools.timing import build_libraries, device_ops, interleaved_ms, kernel_ms, ptxas_usage

REL_L2 = 1e-5  # float32 sums over up to 11.8M elements in another order
DX_REL_L2 = {torch.float32: 1e-6, torch.bfloat16: 1e-2}  # K4 against float64: one rounding, bf16's in bf16
BATCH, CHANNELS = 16, 768
HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's published rate
# the recipe step's LayerNormSpatial sites by side: 3 at 16x16 in each of
# the three 16x16 teachers' heads, 16x16, 31x31 and 64x64 in SAM's and
# Depth-Anything's
SITES = {16: 11, 31: 2, 64: 2}
PTR, I32, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64


@dataclasses.dataclass(frozen=True)
class Target:
    source: str  # under theia_tpu_torch/csrc
    passes: tuple[str, ...]  # ptxas names of its kernels
    ablations: dict[str, tuple[str, ...]]  # name -> the -D settings it builds with


K3 = Target(
    source="ln_bwd.cu",
    passes=("ln_bwd_stats_sm90<bf16>", "ln_bwd_stats_sm90<f32>"),
    ablations={
        "bounds3": ("THEIA_K3_BLOCKS_PER_SM=3",),  # registers capped for 3 blocks a SM (85), not 4 (64)
        "slots2": ("THEIA_K3_SLOTS=2", "THEIA_K3_BLOCKS_PER_SM=3"),  # 2 samples' loads in flight a thread
        "slots4": ("THEIA_K3_SLOTS=4", "THEIA_K3_BLOCKS_PER_SM=2"),
        "p4": ("THEIA_K3_TILE_C=512",),  # 4 positions x 512 channels a tile (768 = 512 + 256), not 16 x 128
        "p8": ("THEIA_K3_TILE_C=256",),  # 8 positions x 256 channels
    },
)
K4 = Target(
    source="ln_bwd.cu",
    passes=("ln_bwd_dx_sm90<bf16>", "ln_bwd_dx_sm90<f32>", "ln_bwd_dx_scalar<bf16>", "ln_bwd_dx_scalar<f32>"),
    ablations={
        "dx_slots1": ("THEIA_K4_SLOTS=1",),  # one sample's loads in flight a thread, not 2
        "dx_slots4": ("THEIA_K4_SLOTS=4", "THEIA_K4_BLOCKS_PER_SM=2", "THEIA_K4_F32_BLOCKS_PER_SM=2"),
        "dx_bounds3": ("THEIA_K4_BLOCKS_PER_SM=3",),  # bf16's registers capped for 3 blocks a SM (85), not 4 (64)
        "dx_f32_bounds4": ("THEIA_K4_F32_BLOCKS_PER_SM=4",),  # float32's capped for 4 (64), not 3 (85)
        "dx_split4": ("THEIA_K4_SPLIT_TARGET=4",),  # split the batch up to 4 blocks a SM, not 2
        "dx_nosplit": ("THEIA_K4_SPLIT_TARGET=0",),  # one block a tile walks the whole batch
        "dx_cached": ("THEIA_K4_STREAMING=0",),  # g, x, dx without the evict-first hints
        "dx_cs_loads": ("THEIA_K4_STREAMING=1",),  # the hints on g's and x's loads only
        "dx_cs_stores": ("THEIA_K4_STREAMING=2",),  # the hints on dx's stores only
        "dx_div": ("THEIA_K4_DIV=1",),  # divide by N, not multiply by its reciprocal
    },
)
PARENT_PASSES = ("ln_bwd_dx<bf16>", "ln_bwd_dx<f32>")  # c76c76f's K4 (one vector a thread, grid-stride)
# B x side x C held to the plain version: one sample to the recipe's 16,
# 7x7 and 31x31 (whose last tile is partial), one vector of channels (256
# positions a tile) and the heads' 768
CHECKS = tuple((b, side, c) for b in (1, 3, 9, 16) for side in (7, 16, 31) for c in (8, 768))
# the recipe's sites, and 7x7 (a 7x7 target's ladder), whose few bytes show a launch's fixed cost
TIMED = ((torch.bfloat16, 7), (torch.bfloat16, 16), (torch.bfloat16, 31), (torch.bfloat16, 64), (torch.float32, 64))
# the conv translator's LayerNormSpatial shapes (C, side) at the same batch
TIMED_WIDE = ((torch.bfloat16, 2048, 64), (torch.float32, 2048, 64), (torch.bfloat16, 1024, 16))
# K4's edges (B, side, C, N over the row): B not a multiple of the batch
# split (the split at 16x16 and 768 channels is 3 runs of 6), S = 1, one
# vector of channels, C = 60 (one element a thread), 2048 at a small side,
# N twice the row (a sample whose channels two ranks split)
DX_CHECKS = tuple((b, side, c, 1) for b in (1, 3, 9, 16) for side in (1, 7, 16, 31) for c in (8, 60, 768)) + (
    (5, 4, 2048, 1), (7, 16, 768, 2), (16, 31, 384, 2), (3, 64, 1024, 2), (13, 16, 768, 1))
# K4 timed at (dtype, B, C, side): the recipe's sites and 7x7; the conv
# translator's; a tensor-parallel rank's split maps (phase 13 of
# chip_smoke.py); the CortexBench policy heads' (B = 32)
DX_TIMED = tuple([(dtype, BATCH, CHANNELS, side) for dtype, side in TIMED]
                 + [(dtype, BATCH, c, side) for c, side in ((2048, 64), (2048, 31), (2048, 16), (1024, 16))
                    for dtype in (torch.bfloat16, torch.float32)]
                 + [(dtype, BATCH, c, side) for c, side in ((384, 31), (384, 64), (1024, 31))
                    for dtype in (torch.bfloat16, torch.float32)]
                 + [(dtype, 32, c, side) for c, side in ((256, 7), (256, 3), (256, 1), (60, 7), (60, 3))
                    for dtype in (torch.bfloat16, torch.float32)])

STATS_SIGNATURES = {"theia_ln_bwd_stats": [PTR] * 10 + [I32] * 4 + [PTR], "theia_ln_bwd_stats_parts": [I32] * 3,
                    "theia_ln_bwd_stats_counter_words": []}
DX_SIGNATURES = {"theia_ln_bwd_dx": [PTR] * 8 + [I32] * 3 + [I64, I32, PTR]}
# K4's one-device-operation check (torch.profiler): the vector path split
# and whole, the one-element path, a one-sample block of a 1x1 map
DX_OPS = ((torch.bfloat16, BATCH, CHANNELS, 16), (torch.float32, BATCH, CHANNELS, 64), (torch.float32, 32, 60, 7),
          (torch.bfloat16, 32, 256, 1))
# c76c76f's K4: the weight as [S, C] float32, the sample's length and the normaliser's count
SC_DX_SIGNATURES = {"theia_ln_bwd_dx": [PTR] * 8 + [I32, I64, I64, I32, PTR]}


def ln_inputs(b: int, c: int, side: int, dtype: torch.dtype, gen: torch.Generator):
    """x, g [B, C, side, side] in channels_last memory, the weight (C, side,
    side) float32, and the forward's float32 mean and r as [B]."""
    x = (torch.randn(b, c, side, side, device="cuda", generator=gen) * 2 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(b, c, side, side, device="cuda", generator=gen).to(dtype)
    g = g.contiguous(memory_format=torch.channels_last)
    w = torch.randn(c, side, side, device="cuda", generator=gen)
    mean, r = (t.reshape(b) for t in ln_pallas.ln_spatial_stats(x, 1e-5))
    return x, w, mean, r, g


def stats_launcher(lib: ctypes.CDLL) -> Callable:
    """K3 through another build of a one-launch K3's source (no checks)."""
    counter = torch.zeros(lib.theia_ln_bwd_stats_counter_words(), dtype=torch.int32, device="cuda")

    def run(x, w, mean, r, g):
        b, c, h, wd = x.shape
        part = torch.empty((2, b, lib.theia_ln_bwd_stats_parts(b, h * wd, c)), dtype=torch.float32, device="cuda")
        sums = torch.empty((2, b), dtype=torch.float32, device="cuda")
        dw, db = torch.empty((2, c, h, wd), dtype=torch.float32, device="cuda").unbind(0)
        err = lib.theia_ln_bwd_stats(g.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(), r.data_ptr(),
                                     part.data_ptr(), counter.data_ptr(), sums.data_ptr(), dw.data_ptr(),
                                     db.data_ptr(), b, h * wd, c, ln_pallas._DTYPE_CODES[x.dtype],
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return sums[0], sums[1], dw, db
    return run


def dx_launcher(lib: ctypes.CDLL, weight_rows: bool = False) -> Callable:
    """K4 through another build's ``theia_ln_bwd_dx`` (no checks): this
    tree's interface, or with ``weight_rows`` c76c76f's, which takes the
    weight permuted to [S, C] by a copy its wrapper made before each call."""
    def run(x, w, mean, r, g, s1, s2, count=None):
        b, c, h, wd = x.shape
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        n = x[0].numel()
        count = n if count is None else count
        if weight_rows:
            w = w.detach().float().permute(1, 2, 0).contiguous()
            sizes = (b, n, count)
        else:
            sizes = (b, h * wd, c, count)
        err = lib.theia_ln_bwd_dx(g.data_ptr(), x.data_ptr(), w.data_ptr(), mean.data_ptr(), r.data_ptr(),
                                  s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), *sizes,
                                  ln_pallas._DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return dx
    return run


def print_ptxas(name: str, log: str) -> None:
    """ptxas's registers and spills of K3 and K4 (and of the parent's K4) in a build's log."""
    for kernel, usage in ptxas_usage(log):
        if kernel in K3.passes + K4.passes + PARENT_PASSES:
            print(f"  {name}: ptxas {kernel}: {usage}")


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def errors(got, want) -> tuple[float, ...]:
    """Relative L2 error of s1, s2, dw and db."""
    return tuple(rel_l2(a, b) for a, b in zip(got, want))


def same(a, b) -> bool:
    return all(torch.equal(u, v) for u, v in zip(a, b))


def bound_ms(x: torch.Tensor) -> float:
    """K3: bytes over the HBM rate: g and x read, the weight read, dw and db
    written in float32, once each."""
    per_sample = x[0].numel()
    return (2 * x.numel() * x.element_size() + 3 * per_sample * 4) / HBM_BYTES_PER_S * 1e3


def dx_bound_ms(x: torch.Tensor) -> float:
    """K4: bytes over the HBM rate: g and x read, dx written, the float32
    weight read, once each."""
    return (3 * x.numel() * x.element_size() + x[0].numel() * 4) / HBM_BYTES_PER_S * 1e3


def library_call(x, w, g) -> Callable:
    """One PyTorch call for the whole LayerNorm backward, on NCHW-contiguous copies."""
    xl, gl, wl = x.contiguous(), g.contiguous(), w.to(x.dtype)
    _, lmean, lrstd = torch.native_layer_norm(xl, wl.shape, wl, torch.zeros_like(wl), 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(gl, xl, list(wl.shape), lmean, lrstd, wl,
                                                             torch.zeros_like(wl), [True, True, True])


def dn(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def k3_section(fns: dict, card: str, gen: torch.Generator) -> int:
    """K3: checks, timings and the profiler's split of every build in ``fns``."""
    lib = build.load()
    for dtype, side in TIMED:
        threads, grid = ctypes.c_int(0), ctypes.c_int(0)
        resident = lib.theia_ln_bwd_stats_blocks_per_sm(side * side, CHANNELS, ln_pallas._DTYPE_CODES[dtype],
                                                        ctypes.byref(threads), ctypes.byref(grid))
        print(f"  K3 [{BATCH},{CHANNELS},{side},{side}] {dn(dtype)}: {resident} resident blocks per SM of "
              f"{threads.value} threads, a grid of {grid.value} blocks")
    worst = {}
    shapes = [(dtype, b, side, c) for dtype in (torch.bfloat16, torch.float32) for b, side, c in CHECKS]
    shapes += [(dtype, BATCH, side, CHANNELS) for dtype, side in TIMED]
    for dtype, b, side, c in shapes:
        x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
        want = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
        got = {name: fn(x, w, mean, r, g) for name, fn in fns.items()}
        errs = {name: errors(out, want) for name, out in got.items()}
        worst = {name: tuple(map(max, zip(worst.get(name, e), e))) for name, e in errs.items()}
        bad = [name for name, e in errs.items() if max(e) > REL_L2]
        if bad:
            print(f"time_ln_bwd: K3 {bad} disagree with the plain version at [{b},{c},{side},{side}] {dtype} "
                  f"(relative L2 s1/s2/dw/db: {errs}; limit {REL_L2})", file=sys.stderr)
            return 1
        if not same(got["kernel"], fns["kernel"](x, w, mean, r, g)):
            print(f"time_ln_bwd: K3's two calls differ at [{b},{c},{side},{side}] {dtype}", file=sys.stderr)
            return 1
        if "parent" in got and not same(got["kernel"], got["parent"]):
            print(f"time_ln_bwd: K3 differs from the parent's at [{b},{c},{side},{side}] {dtype}", file=sys.stderr)
            return 1
    print(f"  K3 worst relative L2 s1/s2/dw/db over the {len(shapes)} check shapes (both dtypes): "
          + "; ".join(f"{n} " + "/".join(f"{e:.2e}" for e in es) for n, es in worst.items())
          + ("; bit-identical to the parent's at every one" if "parent" in fns else ""))
    x, w, mean, r, g = ln_inputs(BATCH, CHANNELS, 16, torch.bfloat16, gen)
    first = fns["kernel"](x, w, mean, r, g)
    runs = [fns["kernel"](x, w, mean, r, g) for _ in range(50)]
    if not all(same(first, run) for run in runs):
        print("time_ln_bwd: K3's 50 calls back to back differ", file=sys.stderr)
        return 1
    print("  K3: bit-identical on two calls at every check shape and over 50 calls back to back")
    step = {}
    for dtype, c, side in [(dtype, CHANNELS, side) for dtype, side in TIMED] + list(TIMED_WIDE):
        x, w, mean, r, g = ln_inputs(BATCH, c, side, dtype, gen)
        timed = {name: (lambda fn=fn: fn(x, w, mean, r, g)) for name, fn in fns.items()}
        timed["plain"] = lambda: ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
        timed["library"] = library_call(x, w, g)
        bound = bound_ms(x)
        for rep in range(3):  # the first round warms the card and is not printed
            ms = interleaved_ms(timed)
            if rep:
                print(f"  K3 [{BATCH},{c},{side},{side}] {dn(dtype)}, device ms (order a..b..a, {card}; bound "
                      f"{bound:.4f}): " + ", ".join(f"{n} {v:.4f} ({100 * bound / v:.0f}%)" for n, v in ms.items()))
                if dtype == torch.bfloat16 and side in SITES and c == CHANNELS:
                    for name in fns:
                        step.setdefault((rep, name), []).append((SITES[side] * ms[name], SITES[side] * bound))
        for name in fns:
            split = kernel_ms(timed[name])
            print(f"  K3 [{BATCH},{c},{side},{side}] {dn(dtype)} {name}, device ms a call by kernel (torch.profiler, "
                  "50 calls): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    for (rep, name), sites in sorted(step.items()):
        total, bound = (sum(v) for v in zip(*sites))
        print(f"  K3, a recipe step's 15 sites (11/2/2 at 16/31/64), bf16, round {rep}: {name} {total:.4f} ms, "
              f"bound {bound:.4f} ms ({100 * bound / total:.0f}%)")
    return 0


def k4_section(fns: dict, card: str, gen: torch.Generator) -> int:
    """K4: checks, timings and the profiler's split of every build in ``fns``."""
    lib = build.load()
    for dtype, b, c, side in DX_TIMED:
        threads, grid = ctypes.c_int(0), ctypes.c_int(0)
        resident = lib.theia_ln_bwd_dx_blocks_per_sm(b, side * side, c, ln_pallas._DTYPE_CODES[dtype],
                                                     ctypes.byref(threads), ctypes.byref(grid))
        print(f"  K4 [{b},{c},{side},{side}] {dn(dtype)}: {resident} resident blocks per SM of {threads.value} "
              f"threads, a grid of {grid.value} blocks")
    worst = {}
    for dtype in (torch.bfloat16, torch.float32):
        for b, side, c, mult in DX_CHECKS:
            x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
            x64, w64, mean64, r64, g64 = (t.double() for t in (x, w, mean, r, g))
            s1, s2 = ln_pallas.ln_bwd_stats_plain(x64, w64, mean64, r64, g64)[:2]
            count = mult * x[0].numel()
            want = ln_pallas.ln_bwd_dx_plain(x64, w64, mean64, r64, g64, s1, s2, count)
            s1, s2 = s1.float(), s2.float()
            got = {name: fn(x, w, mean, r, g, s1, s2, count) for name, fn in fns.items()}
            errs = {name: rel_l2(out, want) for name, out in got.items()}
            worst[dtype] = {name: max(worst.get(dtype, {}).get(name, 0.0), e) for name, e in errs.items()}
            bad = [name for name, e in errs.items() if e > DX_REL_L2[dtype]]
            if bad:
                print(f"time_ln_bwd: K4 {bad} disagree with the plain version at [{b},{c},{side},{side}], "
                      f"N = {mult} x the row, {dtype} (relative L2 {errs}; limit {DX_REL_L2[dtype]})",
                      file=sys.stderr)
                return 1
            if not torch.equal(got["kernel"], fns["kernel"](x, w, mean, r, g, s1, s2, count)):
                print(f"time_ln_bwd: K4's two calls differ at [{b},{c},{side},{side}] {dtype}", file=sys.stderr)
                return 1
    for dtype, errs in worst.items():
        print(f"  K4 worst relative L2 against the plain version in float64 over the {len(DX_CHECKS)} check shapes, "
              f"{dn(dtype)} (limit {DX_REL_L2[dtype]}): " + ", ".join(f"{n} {e:.2e}" for n, e in errs.items()))
    for dtype, b, c, side in ((torch.bfloat16, BATCH, CHANNELS, 16), (torch.float32, 32, 60, 7)):
        x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
        s1, s2 = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)[:2]
        first = fns["kernel"](x, w, mean, r, g, s1, s2)
        runs = [fns["kernel"](x, w, mean, r, g, s1, s2) for _ in range(50)]
        if not all(torch.equal(first, run) for run in runs):
            print(f"time_ln_bwd: K4's 50 calls back to back differ at [{b},{c},{side},{side}]", file=sys.stderr)
            return 1
    print("  K4: bit-identical on two calls at every check shape and over 50 calls back to back")
    for dtype, b, c, side in DX_OPS:
        x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
        s1, s2 = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)[:2]
        ops = device_ops(lambda: ln_pallas.ln_bwd_dx(x, w, mean, r, g, s1, s2))
        print(f"  K4 [{b},{c},{side},{side}] {dn(dtype)}: device operations a call (torch.profiler): {ops}")
        if list(ops.values()) != [1.0] or not next(iter(ops)).startswith("ln_bwd_dx_"):
            print("time_ln_bwd: a K4 call is not one device operation", file=sys.stderr)
            return 1
    # this tree's kernel also through the bare C call, as the other builds are called: the wrapper's own cost
    fns = {"kernel": fns["kernel"], "launcher": dx_launcher(build.load()), **fns}
    step, summary = {}, []
    for dtype, b, c, side in DX_TIMED:
        x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
        s1, s2 = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)[:2]
        shape = f"[{b},{c},{side},{side}] {dn(dtype)}"
        timed = {name: (lambda fn=fn: fn(x, w, mean, r, g, s1, s2)) for name, fn in fns.items()}
        timed["plain"] = lambda: ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2)
        timed["library"] = library_call(x, w, g)
        bound = dx_bound_ms(x)
        for rep in range(3):  # the first round warms the card and is not printed
            ms = interleaved_ms(timed)
            if rep:
                print(f"  K4 {shape}, device ms (order a..b..a, {card}; bound {bound:.4f}): "
                      + ", ".join(f"{n} {v:.4f} ({100 * bound / v:.0f}%)" for n, v in ms.items()))
                summary.append((shape, rep, ms, bound))
                if dtype == torch.bfloat16 and side in SITES and c == CHANNELS:
                    for name in fns:
                        step.setdefault((rep, name), []).append((SITES[side] * ms[name], SITES[side] * bound))
        if (c, side) in ((CHANNELS, 16), (CHANNELS, 64), (2048, 64)):
            for name in ("kernel", "parent"):
                if name in fns:
                    split = kernel_ms(timed[name])
                    print(f"  K4 {shape} {name}, device ms a call by kernel (torch.profiler, 50 calls): "
                          + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
    for (rep, name), sites in sorted(step.items()):
        total, bound = (sum(v) for v in zip(*sites))
        print(f"  K4, a recipe step's 15 sites (11/2/2 at 16/31/64), bf16, round {rep}: {name} {total:.4f} ms, "
              f"bound {bound:.4f} ms ({100 * bound / total:.0f}%)")
    if "parent" in fns:
        print(f"  K4 summary, this tree's kernel against the parent's in the same rounds ({card}):")
        for shape, rep, ms, bound in summary:
            print(f"    {shape} round {rep}: kernel {ms['kernel']:.4f} ms ({100 * bound / ms['kernel']:.1f}% of "
                  f"{bound:.4f}), parent {ms['parent']:.4f} ({100 * bound / ms['parent']:.1f}%), kernel / parent "
                  f"{ms['kernel'] / ms['parent']:.3f}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=("k3", "k4", "both"), default="both", help="which kernels to check and time")
    parser.add_argument("--parent", type=Path, help="an unpacked earlier tree whose csrc/ln_bwd.cu to time too")
    parser.add_argument("--ablations", action="store_true", help="also time the builds of the kernels' ablations")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_ln_bwd: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = build.build()
    usage = dict(ptxas_usage(lib_path.with_suffix(".log").read_text()))
    for kernel in K3.passes + K4.passes:
        print(f"  kernel: ptxas {kernel}: {usage.get(kernel)}")
    targets = {"k3": (K3,), "k4": (K4,), "both": (K3, K4)}[args.kernel]
    csrc = build.PACKAGE_DIR / "csrc" / K3.source
    sources = {}
    chw_parent = False
    if args.parent:
        parent_src = args.parent / "theia_tpu_torch" / "csrc" / K3.source
        parent_text = parent_src.read_text()
        if "theia_ln_bwd_stats_parts" not in parent_text:
            print("time_ln_bwd: the parent's K3 is not one launch; this tool times parents from c76c76f on",
                  file=sys.stderr)
            return 1
        chw_parent = "theia_ln_bwd_dx_blocks_per_sm" in parent_text
        sources["parent"] = (parent_src, (), {**STATS_SIGNATURES,
                                              **(DX_SIGNATURES if chw_parent else SC_DX_SIGNATURES)})
    if args.ablations:
        for target in targets:
            sources.update({name: (csrc, d, {**STATS_SIGNATURES, **DX_SIGNATURES})
                            for name, d in target.ablations.items()})
    stats_fns = {"kernel": ln_pallas.ln_bwd_stats}
    dx_fns = {"kernel": ln_pallas.ln_bwd_dx}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        for name, other in build_libraries(sources, Path(work), print_ptxas).items():
            if name == "parent" or name in K3.ablations:
                stats_fns[name] = stats_launcher(other)
            if name == "parent" or name in K4.ablations:
                dx_fns[name] = dx_launcher(other, weight_rows=name == "parent" and not chw_parent)
        gen = torch.Generator(device="cuda").manual_seed(0)
        if K3 in targets and k3_section(stats_fns, card, gen):
            return 1
        if K4 in targets and k4_section(dx_fns, card, gen):
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
