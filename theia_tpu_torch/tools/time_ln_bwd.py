"""Time K3, the LayerNormSpatial backward's sums (``csrc/ln_bwd.cu``), on one
GPU against its plain version, one PyTorch call and other builds of its source.

    python -m theia_tpu_torch.tools.time_ln_bwd [--parent DIR] [--ablations]

Builds the kernels (``kernels/build.py``) and prints ptxas's registers and
spills of ``ln_bwd_stats_sm90`` in bf16 and float32 and, at each timed
shape, its resident blocks a SM and its grid. ``--parent DIR`` also builds
``csrc/ln_bwd.cu`` of an unpacked earlier tree in DIR: one whose K3 is one
launch (``theia_ln_bwd_stats_parts``) is called through this tree's
launcher, and its K4 is timed beside this tree's too; one whose K3 took
the weight as [S, C] and finished s1, s2 in a second kernel
(``theia_ln_bwd_partials``) through a launcher that does what that tree's
wrapper did, the weight's permuted copy included. ``--ablations`` builds the
source once for each entry of ``TARGET.ablations``, each changing one
constant of the kernel through the ``-D`` switches the source reads. The extra libraries build in parallel. Every build is held to
``ln_bwd_stats_plain`` (relative L2 within 1e-5 on each of s1, s2, dw and
db) at B x S x C in ``CHECKS`` in both dtypes and at the timed shapes; the
port's kernel must also give bit-identical results on two calls and on 50
calls back to back. Then all are timed at ``TIMED`` with the plain version
and ``native_layer_norm_backward``, in the order a, b, ..., b, a (device
time, the stream held while the host enqueues), twice after a round that
warms the card, with each one's share of its bound and the step's sum over
the recipe's 15 sites (11 at 16x16, 2 at 31x31, 2 at 64x64), and at the
conv translator's widest shapes (``TIMED_WIDE``); then each
build's device time by kernel (torch.profiler). Exits nonzero without a
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
from theia_tpu_torch.tools.timing import build_libraries, interleaved_ms, kernel_ms, ptxas_usage

REL_L2 = 1e-5  # float32 sums over up to 11.8M elements in another order
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


TARGET = Target(
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
PARENT_PASSES = ("ln_bwd_stats<bf16>", "ln_bwd_stats<f32>", "ln_bwd_finish")
# B x side x C held to the plain version: one sample to the recipe's 16,
# 7x7 and 31x31 (whose last tile is partial), one vector of channels (256
# positions a tile) and the heads' 768
CHECKS = tuple((b, side, c) for b in (1, 3, 9, 16) for side in (7, 16, 31) for c in (8, 768))
# the recipe's sites, and 7x7 (a 7x7 target's ladder), whose few bytes show a launch's fixed cost
TIMED = ((torch.bfloat16, 7), (torch.bfloat16, 16), (torch.bfloat16, 31), (torch.bfloat16, 64), (torch.float32, 64))
# the conv translator's LayerNormSpatial shapes (C, side) at the same batch
TIMED_WIDE = ((torch.bfloat16, 2048, 64), (torch.float32, 2048, 64), (torch.bfloat16, 1024, 16))

NEW_SIGNATURES = {"theia_ln_bwd_stats": [PTR] * 10 + [I32] * 4 + [PTR], "theia_ln_bwd_stats_parts": [I32] * 3,
                  "theia_ln_bwd_stats_counter_words": [], "theia_ln_bwd_dx": [PTR] * 8 + [I32, I64, I64, I32, PTR]}
# K4 before it took the normaliser's count apart from the row length
UNCOUNTED_K4 = {"theia_ln_bwd_dx": [PTR] * 8 + [I32, I64, I32, PTR]}
PARENT_SIGNATURES = {"theia_ln_bwd_stats": [PTR] * 11 + [I32, I64, I32, PTR], "theia_ln_bwd_partials": [I64]}


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


def new_launcher(lib: ctypes.CDLL) -> Callable:
    """K3 through another build of this tree's source (no checks)."""
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


def dx_launcher(lib: ctypes.CDLL, counted: bool = True) -> Callable:
    """K4 through another build's ``theia_ln_bwd_dx`` (no checks); ``counted``:
    the build takes the normaliser's count after the row length."""
    def run(x, w, mean, r, g, s1, s2):
        w_sc = ln_pallas._rows_sc(w)
        dx = torch.empty_like(x, memory_format=torch.channels_last)
        sizes = (x[0].numel(),) * (2 if counted else 1)  # the row length, and the normaliser's count
        err = lib.theia_ln_bwd_dx(g.data_ptr(), x.data_ptr(), w_sc.data_ptr(), mean.data_ptr(), r.data_ptr(),
                                  s1.data_ptr(), s2.data_ptr(), dx.data_ptr(), x.shape[0], *sizes,
                                  ln_pallas._DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return dx
    return run


def parent_launcher(lib: ctypes.CDLL) -> Callable:
    """The earlier tree's K3 as its wrapper called it: the weight permuted
    to [S, C], the sums kernel and the finishing kernel; dw, db returned as
    (C, H, W) views of its [S, C] outputs."""
    def run(x, w, mean, r, g):
        b, c, h, wd = x.shape
        n = c * h * wd
        w_sc = ln_pallas._rows_sc(w)
        parts = torch.empty((2, b, lib.theia_ln_bwd_partials(n)), dtype=torch.float32, device="cuda")
        sums = torch.empty((2, b), dtype=torch.float32, device="cuda")
        dwb = torch.empty((2, n), dtype=torch.float32, device="cuda")
        err = lib.theia_ln_bwd_stats(g.data_ptr(), x.data_ptr(), w_sc.data_ptr(), mean.data_ptr(), r.data_ptr(),
                                     parts[0].data_ptr(), parts[1].data_ptr(), sums[0].data_ptr(),
                                     sums[1].data_ptr(), dwb[0].data_ptr(), dwb[1].data_ptr(), b, n,
                                     ln_pallas._DTYPE_CODES[x.dtype], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed ({err})")
        return (sums[0], sums[1], *(t.view(h, wd, c).permute(2, 0, 1) for t in dwb))
    return run


def print_ptxas(name: str, log: str) -> None:
    """ptxas's registers and spills of K3 (and of the parent's kernels) in a build's log."""
    for kernel, usage in ptxas_usage(log):
        if kernel in TARGET.passes + PARENT_PASSES:
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
    """Bytes over the HBM rate: g and x read, the weight read, dw and db
    written in float32, once each."""
    per_sample = x[0].numel()
    return (2 * x.numel() * x.element_size() + 3 * per_sample * 4) / HBM_BYTES_PER_S * 1e3


def library_call(x, w, g) -> Callable:
    """One PyTorch call for the whole LayerNorm backward, on NCHW-contiguous copies."""
    xl, gl, wl = x.contiguous(), g.contiguous(), w.to(x.dtype)
    _, lmean, lrstd = torch.native_layer_norm(xl, wl.shape, wl, torch.zeros_like(wl), 1e-5)
    return lambda: torch.ops.aten.native_layer_norm_backward(gl, xl, list(wl.shape), lmean, lrstd, wl,
                                                             torch.zeros_like(wl), [True, True, True])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, help="an unpacked earlier tree whose csrc/ln_bwd.cu to time too")
    parser.add_argument("--ablations", action="store_true", help="also time the builds of the kernel's ablations")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_ln_bwd: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = build.build()
    usage = dict(ptxas_usage(lib_path.with_suffix(".log").read_text()))
    for kernel in TARGET.passes:
        print(f"  kernel: ptxas {kernel}: {usage.get(kernel)}")
    lib = build.load()
    for dtype, side in TIMED:
        threads, grid = ctypes.c_int(0), ctypes.c_int(0)
        resident = lib.theia_ln_bwd_stats_blocks_per_sm(side * side, CHANNELS, ln_pallas._DTYPE_CODES[dtype],
                                                        ctypes.byref(threads), ctypes.byref(grid))
        print(f"  kernel [{BATCH},{CHANNELS},{side},{side}] {str(dtype).split('.')[-1]}: {resident} resident blocks "
              f"per SM of {threads.value} threads, a grid of {grid.value} blocks")
    csrc = build.PACKAGE_DIR / "csrc" / TARGET.source
    sources = {}
    one_launch_parent = counted_parent = False
    if args.parent:
        parent_src = args.parent / "theia_tpu_torch" / "csrc" / TARGET.source
        parent_text = parent_src.read_text()
        one_launch_parent = "theia_ln_bwd_stats_parts" in parent_text
        counted_parent = "int64_t count, int dtype" in parent_text
        signatures = NEW_SIGNATURES if counted_parent else {**NEW_SIGNATURES, **UNCOUNTED_K4}
        sources["parent"] = (parent_src, (), signatures if one_launch_parent else PARENT_SIGNATURES)
    if args.ablations:
        sources.update({name: (csrc, d, NEW_SIGNATURES) for name, d in TARGET.ablations.items()})
    fns = {"kernel": ln_pallas.ln_bwd_stats}
    dx_fns = {"kernel": ln_pallas.ln_bwd_dx}
    with tempfile.TemporaryDirectory(dir=build.BUILD_DIR) as work:
        for name, other in build_libraries(sources, Path(work), print_ptxas).items():
            old = name == "parent" and not one_launch_parent
            fns[name] = parent_launcher(other) if old else new_launcher(other)
            if name == "parent" and one_launch_parent:
                dx_fns[name] = dx_launcher(other, counted_parent)
        gen = torch.Generator(device="cuda").manual_seed(0)
        worst = {}
        shapes = [(dtype, b, side, c) for dtype in (torch.bfloat16, torch.float32) for b, side, c in CHECKS]
        shapes += [(dtype, BATCH, side, CHANNELS) for dtype, side in TIMED]
        for dtype, b, side, c in shapes:
            x, w, mean, r, g = ln_inputs(b, c, side, dtype, gen)
            want = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
            errs = {name: errors(fn(x, w, mean, r, g), want) for name, fn in fns.items()}
            worst = {name: tuple(map(max, zip(worst.get(name, e), e))) for name, e in errs.items()}
            bad = [name for name, e in errs.items() if max(e) > REL_L2]
            if bad:
                print(f"time_ln_bwd: {bad} disagree with the plain version at [{b},{c},{side},{side}] {dtype} "
                      f"(relative L2 s1/s2/dw/db: {errs}; limit {REL_L2})", file=sys.stderr)
                return 1
            first = fns["kernel"](x, w, mean, r, g)
            if not same(first, fns["kernel"](x, w, mean, r, g)):
                print(f"time_ln_bwd: two calls differ at [{b},{c},{side},{side}] {dtype}", file=sys.stderr)
                return 1
        print(f"  worst relative L2 s1/s2/dw/db over the {len(shapes)} check shapes (both dtypes): "
              + "; ".join(f"{n} " + "/".join(f"{e:.2e}" for e in es) for n, es in worst.items()))
        x, w, mean, r, g = ln_inputs(BATCH, CHANNELS, 16, torch.bfloat16, gen)
        first = fns["kernel"](x, w, mean, r, g)
        runs = [fns["kernel"](x, w, mean, r, g) for _ in range(50)]
        if not all(same(first, run) for run in runs):
            print("time_ln_bwd: 50 calls back to back differ", file=sys.stderr)
            return 1
        print("  the kernel: bit-identical on two calls at every check shape and over 50 calls back to back")
        step = {}
        for dtype, c, side in [(dtype, CHANNELS, side) for dtype, side in TIMED] + list(TIMED_WIDE):
            x, w, mean, r, g = ln_inputs(BATCH, c, side, dtype, gen)
            s1, s2 = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)[:2]
            dn = str(dtype).split(".")[-1]
            timed = {name: (lambda fn=fn: fn(x, w, mean, r, g)) for name, fn in fns.items()}
            timed["plain"] = lambda: ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
            timed["library"] = library_call(x, w, g)
            bound = bound_ms(x)
            for rep in range(3):  # the first round warms the card and is not printed
                ms = interleaved_ms(timed)
                if rep:
                    print(f"  K3 [{BATCH},{c},{side},{side}] {dn}, device ms (order a..b..a, {card}; bound "
                          f"{bound:.4f}): " + ", ".join(f"{n} {v:.4f} ({100 * bound / v:.0f}%)" for n, v in ms.items()))
                    if dtype == torch.bfloat16 and side in SITES and c == CHANNELS:
                        for name in fns:
                            step.setdefault((rep, name), []).append((SITES[side] * ms[name], SITES[side] * bound))
            if len(dx_fns) > 1:
                want = ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2)
                for name, fn in dx_fns.items():
                    err = rel_l2(fn(x, w, mean, r, g, s1, s2), want)
                    if err > (REL_L2 if dtype == torch.float32 else 1e-2):
                        print(f"time_ln_bwd: K4 {name} disagrees with the plain version at [{BATCH},{c},{side},{side}] "
                              f"{dn} (relative L2 {err:.2e})", file=sys.stderr)
                        return 1
                timed_dx = {name: (lambda fn=fn: fn(x, w, mean, r, g, s1, s2)) for name, fn in dx_fns.items()}
                dx_bound = (3 * x.numel() * x.element_size() + x[0].numel() * 4) / HBM_BYTES_PER_S * 1e3
                for rep in range(3):
                    ms = interleaved_ms(timed_dx)
                    if rep:
                        print(f"  K4 [{BATCH},{c},{side},{side}] {dn}, device ms (order a..b..a, {card}; bound "
                              f"{dx_bound:.4f}): " + ", ".join(f"{n} {v:.4f} ({100 * dx_bound / v:.0f}%)"
                                                              for n, v in ms.items()))
            for name in fns:
                split = kernel_ms(timed[name])
                print(f"  K3 [{BATCH},{c},{side},{side}] {dn} {name}, device ms a call by kernel (torch.profiler, "
                      "50 calls): " + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        for (rep, name), sites in sorted(step.items()):
            total, bound = (sum(v) for v in zip(*sites))
            print(f"  a recipe step's 15 sites (11/2/2 at 16/31/64), bf16, round {rep}: {name} {total:.4f} ms, "
                  f"bound {bound:.4f} ms ({100 * bound / total:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
