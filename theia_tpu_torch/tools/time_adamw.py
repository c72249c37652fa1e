"""Time K10, the masked AdamW step in one launch (``csrc/adamw.cu``), on one
GPU against its plain version and its bound.

    python -m theia_tpu_torch.tools.time_adamw [--config base|small|both] [--iters N]

Builds the kernels and prints ptxas's registers and spills of each K10
instantiation and its resident blocks a SM. At Theia-Base's and
Theia-Small's cddsv parameter shapes (268 tensors; float32 parameters and
grads, bf16 moments, the recipe's warmup schedule, no mask), once with every
grad contiguous and once with the grads laid out as the recipe's backward
lays them out (``grads_like``), it first holds K10 to
``update_plain`` bit for bit over 2 steps, then prints:

- K10's kernel alone (device ms a call, torch.profiler) beside its bound
  (bytes an element: p read and written, g read, mu and nu read and written,
  over 3.35 TB/s) and its share of the bound;
- the whole update on K10: device ms a call with the stream held (the
  schedule's ops, K10, ``sched_count += 1``), the host's ms a call and the
  kernels a call;
- the plain loop: its kernels' device ms a call (torch.profiler), its wall
  ms a call back to back, and its kernels a call.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time

import torch

from theia_tpu_torch.foundation.common import get_model_feature_size
from theia_tpu_torch.kernels import build
from theia_tpu_torch.models.hub import TEACHER_SETS
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.tools.timing import SLEEP_CYCLES_PER_MS, cuda_ms, device_ops, kernel_ms, ptxas_usage
from theia_tpu_torch.train import optim

BACKBONES = {"base": "facebook/deit-base-patch16-224", "small": "facebook/deit-small-patch16-224"}
HBM_BYTES_PER_MS = 3.35e9


def shapes(size: str) -> dict[str, torch.Size]:
    teachers = {t: get_model_feature_size(t, keep_spatial=True) for t in TEACHER_SETS["cddsv"]}
    with torch.device("meta"):
        model = Theia(backbone=BACKBONES[size], translator="lconv", target_feature_sizes=teachers)
    return {n: p.shape for n, p in model.named_parameters()}


def grads_like(params: dict, recipe_layout: bool, gen: torch.Generator) -> dict:
    """Random grads of ``params``; with ``recipe_layout``, laid out as the
    recipe's backward lays them out: a translator 3x3 conv weight's in
    channels_last memory (cuDNN's), the patch embedding's as [kh][c][o][kw]
    (a matmul over unfolded patches). Else every grad contiguous."""
    grads = {}
    for n, p in params.items():
        g = torch.randn(p.shape, generator=gen, device=p.device)
        if recipe_layout and p.dim() == 4 and n.startswith("translator.") and p.shape[2] * p.shape[3] > 1:
            g = g.contiguous(memory_format=torch.channels_last)
        elif recipe_layout and p.dim() == 4 and "patch_embeddings" in n:
            g = g.permute(2, 1, 0, 3).contiguous().permute(2, 1, 0, 3)
        grads[n] = g
    return grads


def setup(size: str, recipe_layout: bool, gen: torch.Generator):
    """``size``'s parameters (float32, drawn), grads (``grads_like``) and the
    recipe's optimizer (warmup schedule, decay 0.01, bf16 moments)."""
    params = {n: torch.randn(s, generator=gen, device="cuda") * 0.05 for n, s in shapes(size).items()}
    tx = optim.make_optimizer(optim.constant_with_warmup(2e-3, 10), weight_decay=0.01,
                              moment_dtype=torch.bfloat16)
    return params, grads_like(params, recipe_layout, gen), tx


def host_ms(fn, calls: int = 20) -> float:
    """The host's ms a call of ``fn`` while the device sleeps, so that no
    call waits on a full launch queue."""
    torch.cuda.synchronize()
    torch.cuda._sleep(int(200 * SLEEP_CYCLES_PER_MS))
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    out = (time.perf_counter() - t0) * 1e3 / calls
    torch.cuda.synchronize()
    return out


def wall_ms(fn, calls: int) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def section(size: str, recipe_layout: bool, iters: int) -> int:
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, grads, tx = setup(size, recipe_layout, gen)
    n = sum(p.numel() for p in params.values())
    bound = n * (2 * 4 + 4 + 2 * 2 * 2) / HBM_BYTES_PER_MS
    label = f"{size} ({len(params)} tensors, {n:,} elements, {'grads in the recipe layouts' if recipe_layout else 'grads contiguous'})"

    plain = {k: v.clone() for k, v in params.items()}
    state, plain_state = tx.init(params), tx.init(plain)
    for _ in range(2):
        tx.update(grads, state, params)
        tx.update_plain(grads, plain_state, plain)
    torch.cuda.synchronize()
    same = all(torch.equal(params[k], plain[k]) and torch.equal(state.mu[k], plain_state.mu[k])
               and torch.equal(state.nu[k], plain_state.nu[k]) for k in params)
    print(f"{label}: K10 bit-equal to update_plain over 2 steps: {same}")
    if not same:
        return 1
    del plain, plain_state

    k10 = lambda: tx.update(grads, state, params)  # noqa: E731
    loop = lambda: tx.update_plain(grads, state, params)  # noqa: E731
    kernels = kernel_ms(k10, iters)
    alone = sum(ms for name, ms in kernels.items() if name.startswith("adamw_sm90"))
    print(f"  K10 kernel alone {alone:.4f} ms a call; bound {bound:.4f} ms (bytes, {20 * n / 1e9:.3f} GB); "
          f"{100 * bound / alone:.1f}% of the bound")
    print(f"  update on K10: device {cuda_ms(k10, iters, hold=True):.4f} ms a call (stream held), host "
          f"{host_ms(k10):.4f} ms a call, kernels a call {sum(device_ops(k10).values()):.0f}")
    loop_kernels = kernel_ms(loop, 3)
    print(f"  update_plain: device {sum(loop_kernels.values()):.4f} ms a call (sum of its kernels), wall "
          f"{wall_ms(loop, 5):.4f} ms a call, kernels a call {sum(device_ops(loop, iters=2, sessions=1).values()):.0f}")
    return 0


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config", choices=("base", "small", "both"), default="both")
    parser.add_argument("--iters", type=int, default=50, help="calls a timing averages over")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_adamw: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card)
    lib_path = build.build()
    lib = build.load()
    for kernel, usage in ptxas_usage(lib_path.with_suffix(".log").read_text()):
        if kernel.startswith("adamw"):
            print(f"  ptxas {kernel}: {usage}")
    for (dtype, moments), name in {(0, 0): "f32,f32", (0, 1): "f32,bf16", (1, 0): "bf16,f32",
                                   (1, 1): "bf16,bf16"}.items():
        print(f"  adamw_sm90<{name}>: {lib.theia_adamw_blocks_per_sm(dtype, moments)} blocks of 256 a SM")
    sizes = ("base", "small") if args.config == "both" else (args.config,)
    for size in sizes:
        for recipe_layout in (True, False):
            if section(size, recipe_layout, args.iters):
                return 1
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
