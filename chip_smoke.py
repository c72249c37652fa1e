#!/usr/bin/env python3
"""Drive the PyTorch port's Theia serving path once on one CUDA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, nvcc and nothing of JAX. Phases, each of which raises on
failure (the script then exits nonzero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``theia_tpu_torch/csrc`` (nvcc, ctypes);
3. each kernel against its plain PyTorch version at the main path's shapes;
4. the main path: Theia-Base cddsv (seeded random weights) behind
   ``serving.Predictor``, answering requests through ``forward_feature``,
   ``predict`` and ``predict_stream`` in float32, then ``forward_feature``
   in bf16; shapes, finiteness, the kernel's launch count, and agreement
   with the same model on the plain attention path;
5. timings with CUDA events after warmup.

The last two lines of standard output are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory without the package beside it, the script exits nonzero.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

MODEL = "theaiinstitute/theia-base-patch16-224-cddsv"
BUCKETS = (1, 4, 16, 64)
REQUESTS = (1, 3, 16, 70)
HEADS, HEAD_DIM = 12, 64
# kernel vs plain: float32 sums in another order; bf16 against the plain
# version run in float32 on the same bf16 inputs (P and O round to bf16)
KERNEL_F32_ATOL = 2e-5
KERNEL_BF16_REL_L2 = 1e-2
# the whole model, kernel path vs plain attention path, float32: 12 blocks
# and the heads, sums in another order
MODEL_F32_ATOL = 1e-3
# bf16 model vs float32 model, relative L2 over the backbone tokens
MODEL_BF16_REL_L2 = 5e-2


def rel_l2(got: torch.Tensor | np.ndarray, want: torch.Tensor | np.ndarray) -> float:
    got, want = (torch.as_tensor(x).double() for x in (got, want))
    return float((got - want).norm() / want.norm())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def packed_qkv(b: int, t: int, dtype: torch.dtype, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    """q, k, v [B, T, 12, 64] as the encoder hands them to the kernel: views
    into one packed QKV projection [B, T, 3*768]."""
    qkv = torch.randn(b, t, 3 * HEADS * HEAD_DIM, device="cuda", generator=gen).to(dtype)
    return tuple(y.view(b, t, HEADS, HEAD_DIM) for y in qkv.split(HEADS * HEAD_DIM, dim=-1))


def compare_kernels(attention) -> dict:
    """Phase 3: mha_fwd against mha_fwd_plain at [B, T, 12, 64]."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b in (1, 64):
            for t in (197, 204):
                q, k, v = packed_qkv(b, t, dtype, gen)
                got = attention.mha_fwd(q, k, v)
                torch.cuda.synchronize()
                if dtype == torch.float32:
                    want = attention.mha_fwd_plain(q, k, v)
                    err = float((got - want).abs().max())
                    ok = err <= KERNEL_F32_ATOL
                    print(f"mha_fwd f32  [{b},{t},12,64] max_abs_err={err:.3e} (atol {KERNEL_F32_ATOL})")
                else:
                    want = attention.mha_fwd_plain(q.float(), k.float(), v.float())
                    err = float((got.float() - want).abs().max())
                    rel = rel_l2(got.float(), want)
                    ok = rel < KERNEL_BF16_REL_L2
                    print(f"mha_fwd bf16 [{b},{t},12,64] max_abs_err={err:.3e} rel_l2={rel:.3e} "
                          f"(< {KERNEL_BF16_REL_L2})")
                check(ok, f"mha_fwd disagrees with its plain version ({dtype}, B={b}, T={t})")
                errors[(dtype, b, t)] = err
    return errors


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import theia_tpu_torch

    here = Path(__file__).resolve().parent
    if Path(theia_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: theia_tpu_torch not found beside {here}", file=sys.stderr)
        return 1
    from theia_tpu_torch.kernels import build
    from theia_tpu_torch.models import vit
    from theia_tpu_torch.models.hub import build_theia, parse_model_name
    from theia_tpu_torch.ops import attention
    from theia_tpu_torch.serving import Predictor

    # phase 1: the card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    device_name = torch.cuda.get_device_name(0)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s)")

    # phase 2: build
    t0 = time.perf_counter()
    lib_path = build.build()
    build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.relative_to(here)}")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # phase 3: kernel vs plain; float32 phases run with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    kernel_errors = compare_kernels(attention)

    # phase 4: the main path
    t0 = time.perf_counter()
    model = build_theia(MODEL, dtype=torch.float32, device="cuda", generator=torch.Generator().manual_seed(0))
    model_bf16 = build_theia(MODEL, dtype=torch.bfloat16, device="cuda", generator=torch.Generator().manual_seed(0))
    print(f"built {MODEL} (seeded random weights) in float32 and bf16: {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8) for n in REQUESTS]
    ff = Predictor(model, buckets=BUCKETS)
    predict = Predictor(model, buckets=BUCKETS, method="predict")
    ff_bf16 = Predictor(model_bf16, buckets=BUCKETS)

    attention.MHA_FWD_LAUNCHES = 0
    t0 = time.perf_counter()
    feats = [ff(x) for x in requests]
    preds = [predict(x) for x in requests]
    streamed = list(ff.predict_stream(iter(requests)))
    feats_bf16 = [ff_bf16(x) for x in requests]
    launches = attention.MHA_FWD_LAUNCHES
    main_s = time.perf_counter() - t0
    batches_per_pass = sum(math.ceil(n / BUCKETS[-1]) for n in REQUESTS)
    expected = 4 * batches_per_pass * model.backbone.cfg.num_layers
    print(f"main path: {sum(REQUESTS)} images x 4 passes in {main_s:.1f} s; mha_fwd launches {launches}, "
          f"expected 12 layers x {4 * batches_per_pass} bucket batches = {expected}")
    check(launches == expected, f"mha_fwd launched {launches} times on the main path, expected {expected}")

    _, teachers = parse_model_name(MODEL)
    sizes = {t: model.translator.target_feature_sizes[t] for t in teachers}
    for n, f, p, s, fb in zip(REQUESTS, feats, preds, streamed, feats_bf16):
        for name, arr in [("forward_feature", f), ("stream", s), ("bf16 forward_feature", fb)]:
            check(arr.shape == (n, 196, 768), f"{name} shape {arr.shape}")
            check(bool(np.isfinite(arr).all()), f"{name} has non-finite values")
        for t, (c, h, w) in sizes.items():
            check(p[t].shape == (n, h * w, c), f"predict[{t}] shape {p[t].shape}")
            check(bool(np.isfinite(p[t]).all()), f"predict[{t}] has non-finite values")
        np.testing.assert_allclose(s, f, atol=1e-6, rtol=0, err_msg="stream vs direct")
    print("shapes: forward_feature [n,196,768]; predict " +
          ", ".join(f"[n,{h * w},{c}]" for c, h, w in sizes.values()) + "; all finite")

    # the same requests on the plain attention path ("einsum"), same weights
    backbone_name, _ = parse_model_name(MODEL)
    saved = vit.BACKBONE_CONFIGS[backbone_name]
    vit.BACKBONE_CONFIGS[backbone_name] = dataclasses.replace(saved, attention_impl="einsum")
    try:
        plain_model = build_theia(MODEL, dtype=torch.float32, device="cuda")
    finally:
        vit.BACKBONE_CONFIGS[backbone_name] = saved
    plain_model.load_state_dict(model.state_dict())
    check(plain_model.backbone.cfg.attention_impl == "einsum", "plain model does not use the plain attention")
    plain_ff = Predictor(plain_model, buckets=BUCKETS)
    plain_predict = Predictor(plain_model, buckets=BUCKETS, method="predict")
    worst_ff = max(float(np.abs(f - plain_ff(x)).max()) for f, x in zip(feats, requests))
    worst_pred = 0.0
    for p, x in zip(preds, requests):
        q = plain_predict(x)
        worst_pred = max(worst_pred, max(float(np.abs(p[t] - q[t]).max()) for t in sizes))
    print(f"kernel path vs plain attention path (float32): forward_feature max_abs {worst_ff:.3e}, "
          f"predict max_abs {worst_pred:.3e} (atol {MODEL_F32_ATOL})")
    check(max(worst_ff, worst_pred) <= MODEL_F32_ATOL, "kernel path disagrees with the plain path")
    bf16_err = max(rel_l2(fb, f) for fb, f in zip(feats_bf16, feats))
    print(f"bf16 vs float32 forward_feature: rel_l2 {bf16_err:.3e} (< {MODEL_BF16_REL_L2})")
    check(bf16_err < MODEL_BF16_REL_L2, "bf16 forward_feature far from float32")
    del plain_model, plain_ff, plain_predict, preds

    # phase 5: timings
    print(f"timings on {card}:")
    x1 = torch.from_numpy(requests[0]).cuda()
    x64 = torch.from_numpy(requests[3][:64]).cuda()
    with torch.inference_mode():
        for _ in range(5):
            model.forward_feature(x1)
        samples = []
        for _ in range(50):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model.forward_feature(x1)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
        print(f"  forward_feature B=1 latency p50 {statistics.median(samples):.3f} ms "
              f"(min {min(samples):.3f}, max {max(samples):.3f}, 50 calls, CUDA events around each "
              "synchronous call, so the host's kernel launches are included)")
    wall = []
    for _ in range(30):
        t0 = time.perf_counter()
        ff(requests[0])
        wall.append((time.perf_counter() - t0) * 1e3)
    print(f"  Predictor forward_feature B=1 wall p50 {statistics.median(wall[5:]):.3f} ms "
          "(uint8 host in, float32 host out, host clock)")
    with torch.inference_mode():
        for name, m in (("float32", model), ("bf16", model_bf16)):
            for _ in range(3):
                m.forward_feature(x64)
            ms = cuda_ms(lambda: m.forward_feature(x64), 10)
            print(f"  forward_feature B=64 {name}: {ms:.3f} ms/batch, {64 / ms * 1e3:.1f} images/s (CUDA events)")

    kernel_ms, plain_ms = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(1)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = packed_qkv(64, 197, dtype, gen)
        kern = lambda: attention.mha_fwd(q, k, v)  # noqa: E731
        plain = lambda: attention.mha_fwd_plain(q, k, v)  # noqa: E731
        for fn in (kern, plain):
            for _ in range(3):
                fn()
        p1, k1, k2, p2 = cuda_ms(plain, 20), cuda_ms(kern, 20), cuda_ms(kern, 20), cuda_ms(plain, 20)
        kernel_ms[dtype], plain_ms[dtype] = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"  mha_fwd {str(dtype).split('.')[-1]} [64,197,12,64]: kernel {kernel_ms[dtype]:.4f} ms, "
              f"plain {plain_ms[dtype]:.4f} ms (order plain, kernel, kernel, plain; 20 calls each)")

    record = {"kernels": [{
        "name": "mha_fwd",
        "route": "cuda",
        "source": "theia_tpu_torch/csrc/mha_fwd.cu",
        "replaces": "theia_tpu/ops/attention.py:46",
        "launches": launches,
        "max_abs_err": kernel_errors[(torch.float32, 64, 197)],
        "ms": kernel_ms[torch.float32],
        "plain_ms": plain_ms[torch.float32],
    }]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
