"""Where the time of the port's distillation train step goes, on one GPU.

    python -m theia_tpu_torch.tools.profile_train_step [--batch 16] [--steps 3] [--recipe]
        [--attention pallas|flash] [--trace FILE]

Builds Theia-Base cddsv (seeded random weights, float32 params, bf16
compute) with the recipe's optimizer (masked AdamW, bf16 moments), as
``chip_smoke.py`` trains it (``--recipe``: with the production recipe's
``fast_math`` and ``fuse_preprocessing``; else the exact mode, whose
encoder attention is ``--attention``: K1/K2, or the flash kernels
K7/K9/K8), and after warmup prints:
  - the step's phases by CUDA events, each ended by a synchronize: forward
    and loss, backward (``torch.autograd.grad``), optimizer update;
  - device time by kernel class over ``--steps`` whole steps, from
    ``torch.profiler`` (CUPTI), and the device's busy and idle share over
    the traced span.
``--trace`` also writes the chrome trace there. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

import numpy as np
import torch

MODEL = "theaiinstitute/theia-base-patch16-224-cddsv"

# kernel-name substrings -> class, first match wins
CLASSES = (
    ("K1 mha_fwd", ("mha_fwd",)),
    ("K2 mha_bwd", ("mha_bwd",)),
    ("K7 flash_fwd", ("flash_fwd",)),
    ("K9 flash_dq", ("flash_dq",)),
    ("K8 flash_dkv", ("flash_dkv",)),
    ("K3 ln_bwd_stats", ("ln_bwd_stats",)),
    ("K4 ln_bwd_dx", ("ln_bwd_dx",)),
    ("K5 loss_sums_fwd", ("loss_sums_partial", "loss_sums_finish")),
    ("K6 loss_sums_bwd", ("loss_sums_bwd",)),
    ("conv (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad", "implicit", "xmma_fprop", "winograd")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas", "Kernel2")),
    ("LayerNorm (encoder)", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "foreach")),
)


def kernel_class(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in the trace's us -> ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--recipe", action="store_true", help="fast_math and fuse_preprocessing on")
    parser.add_argument("--attention", choices=("pallas", "flash"), default="pallas",
                        help="the encoder's attention_impl (the exact mode's; fast_math does not use it)")
    parser.add_argument("--trace", default=None, help="write the chrome trace here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 1
    from theia_tpu_torch.foundation.common import get_model_feature_size
    from theia_tpu_torch.models import vit
    from theia_tpu_torch.models.hub import build_theia, parse_model_name
    from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
    from theia_tpu_torch.train.optim import constant_with_warmup, make_optimizer, scaled_lr
    from theia_tpu_torch.train.state import TrainState
    from theia_tpu_torch.train.step import make_train_step, prepare_targets

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    backbone, teachers = parse_model_name(MODEL)
    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (args.batch, 224, 224, 3), dtype=np.uint8)).cuda()
    targets = {t: torch.from_numpy(rng.standard_normal((args.batch, *get_model_feature_size(t, keep_spatial=True)),
                                                       dtype=np.float32)).to("cuda", torch.bfloat16)
               for t in teachers}
    flags = dict(fast_math=True, fuse_preprocessing=True) if args.recipe else {}
    saved = vit.BACKBONE_CONFIGS[backbone]
    vit.BACKBONE_CONFIGS[backbone] = dataclasses.replace(saved, attention_impl=args.attention)
    try:
        model = build_theia(MODEL, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(2), **flags)
    finally:
        vit.BACKBONE_CONFIGS[backbone] = saved
    tx = make_optimizer(constant_with_warmup(scaled_lr(2e-3, args.batch, 1), 2), weight_decay=0.01,
                        moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx, main_loss="cos_l1")
    for _ in range(3):
        step(state, images, targets)
    torch.cuda.synchronize()

    # phases, each ended by a synchronize
    names = list(state.params)
    phases = defaultdict(list)
    for _ in range(3):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        loss = main_loss_from_terms(get_loss(model(images), prepare_targets(targets)), "cos_l1")
        ev[1].record()
        torch.cuda.synchronize()
        grads = dict(zip(names, torch.autograd.grad(loss, [state.params[n] for n in names])))
        ev[2].record()
        torch.cuda.synchronize()
        tx.update(grads, state.opt_state, state.params)
        ev[3].record()
        torch.cuda.synchronize()
        for name, a, b in (("forward + loss", 0, 1), ("backward", 1, 2), ("optimizer update", 2, 3)):
            phases[name].append(ev[a].elapsed_time(ev[b]))
    print(f"{MODEL}, batch {args.batch}, float32 params, bf16 compute, {flags or 'exact mode'}, attention "
          f"{args.attention} ({card})")
    for name, ms in phases.items():
        print(f"  phase {name}: {np.median(ms):.3f} ms (median of 3, synchronized between phases)")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.steps):
            step(state, images, targets)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = args.trace or os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and "dur" in e]
    if not kernels:
        print("  the trace holds no device kernels")
        return 1
    by_class = defaultdict(float)
    for e in kernels:
        by_class[kernel_class(e["name"])] += e["dur"] / 1e3
    span = (max(e["ts"] + e["dur"] for e in kernels) - min(e["ts"] for e in kernels)) / 1e3
    busy = busy_ms([(e["ts"], e["ts"] + e["dur"]) for e in kernels])
    total = sum(by_class.values())
    print(f"  traced {args.steps} steps: span {span / args.steps:.3f} ms/step, kernels busy {busy / args.steps:.3f} "
          f"ms/step, idle {100 * (1 - busy / span):.1f}%, {len(kernels) // args.steps} kernels/step")
    for label, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {label}: {ms / args.steps:.3f} ms/step ({100 * ms / total:.1f}% of kernel time)")
    by_name = defaultdict(lambda: [0.0, 0])
    for e in kernels:
        by_name[e["name"]][0] += e["dur"] / 1e3
        by_name[e["name"]][1] += 1
    print("  top kernels:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
        print(f"    {ms / args.steps:8.3f} ms/step {n // args.steps:5d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
