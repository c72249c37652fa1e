#!/usr/bin/env python3
"""Drive the PyTorch port's Theia serving and training paths once on one CUDA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, nvcc and nothing of JAX. Phases, each of which raises on
failure (the script then exits nonzero and prints no result):

1. the card's name and power limit (nvidia-smi);
2. build of the CUDA kernels from ``theia_tpu_torch/csrc`` (nvcc, ctypes),
   ptxas's registers and spills, and the resident blocks per SM of K1 in
   bf16 and float32, of K2's two passes in bf16 and float32, of float32 K7,
   K9 and K8, of bf16 K7, K9 and K8 and of K3;
3. each kernel against its plain PyTorch version at the main paths' shapes:
   K1 (attention forward) and K2 (attention backward) at [B, 197|204, 12,
   64] as views of a packed QKV projection and over a sweep of head dim x
   T (K1: T at the edges of its 64-key chunks, row blocks, 8-key tiles
   and 16-row groups; K2: of its 8-key tiles and 16-row warps), both in
   bf16 also with scores x 40 (probabilities below
   2^-90, which take the IEEE division), K7 (flash forward), K9 (flash
   dQ) and K8 (flash dK, dV) at [B, 197|204, 12, 64] and [16, 785, 12, 64]
   as such views and over a sweep of head dim x T (float32 K9/K8 also at
   the edges of their 16-row groups and 64-row tiles, bf16 K7-K9 at the
   edges of their 128-row blocks), bf16 K7-K9 also where every key tile
   raises the row max and where most probabilities underflow, K3 and K4
   (LayerNormSpatial backward) at every ladder LayerNorm of the Theia-Base
   cddsv heads, K3 also over B x S x C at its edges, bit-identical across
   calls, over 50 calls back to back and on two streams at once, one launch
   a call (torch.profiler),
   K5 and K6 (the fused loss's sums and d pred) at the five
   cddsv teachers' [16, D] and over a sweep of B and D;
4. serving: Theia-Base cddsv (seeded random weights) behind
   ``serving.Predictor``, answering requests through ``forward_feature``,
   ``predict`` and ``predict_stream`` in float32, then ``forward_feature``
   in bf16; shapes, finiteness, K1's launch count, and agreement with the
   same model on the plain attention path; the same requests through
   ``attention_impl="flash"`` (K7) in float32 and bf16; then
   ``forward_feature`` on uint8 448² images without resize and with
   interpolated position embeddings (T = 785, past K1's 256 tokens),
   through "flash" and "pallas" (both K7), against "einsum";
5. training in the JAX package's exact mode: the distillation train step
   (``train.step.make_train_step``) of Theia-Base cddsv, float32 params and
   bf16 compute, masked AdamW with bf16 moments at the recipe's settings,
   batch 16, on one fixed batch: finite and falling loss, one eval step,
   exact launch counts of K1-K6; one step's loss and gradients on the
   kernel path against the plain path (float32, TF32 off), and bf16
   gradients against float32 ones; then the same with
   ``attention_impl="flash"`` (K7, K9, K8 in place of K1, K2), and one
   forward and backward of the backbone on 448² images through "pallas"
   (the flash kernels at T = 785) against autograd through "einsum";
6. training at the production recipe (theia_tpu/configs/training/
   frame_level.yaml): the same step with ``fast_math`` and
   ``fuse_preprocessing``, full width and depth: finite and falling loss,
   exact launch counts (K1 = K2 = 0, K3-K6 on every step), one float32
   step on the kernel path against the plain path, and ``forward_feature``
   with the fused preprocessing against the unfused one;
6b. the training runtime, this slice's main path: ``train.loop.train_from_config``
   on the recipe's config (``load_config("train_rvfm_imagenet", ...)``,
   Theia-Base cddsv, batch 16) over synthetic shards at the teachers' real
   sizes (96 train and 16 val samples, 224² uint8 images, bf16 features)
   in a temporary directory whose free space is checked first: 6 steps, an
   async save at step 3 and the blocking one at step 6, one eval step
   (finite losses), exact launch counts (K3 = K4 = 90, K5 = 35, K6 = 30,
   K1 = K2 = K7-K9 = 0), a JSONL log at steps 2, 4 and 6; a restore of step
   6 into a TrainState built on the card as the loop builds it, every
   tensor equal to the file's and the model's own parameters moved; then
   ``training.epochs=2``, which resumes at step 6 and ends at 12. It prints
   the loop's wall time a step, images/s, the loaders' share of the wall,
   each save's blocked and written time and the restore's, beside the
   card's name and power limit;
7. timings with CUDA events after warmup (bf16 ``forward_feature`` at B=64
   also with the stream held, the device's time alone), and each kernel's
   bound and library call; K3's and K4's sums over a recipe step's 15
   LayerNormSpatial sites against their bounds.

The last two lines of standard output are the kernels' JSON record (the
bf16 figures; ``mha_fwd``, ``mha_bwd``, ``flash_fwd``, ``flash_dq`` and
``flash_dkv`` also carry their float32 ones under ``"float32"``, with the 3xTF32
tensor-core floor, and ``flash_dkv``'s the pair K9 + K8's under ``"pair"``)
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory without the package beside it, the script exits nonzero.
"""

from __future__ import annotations

import ctypes
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
# version on the same bf16 inputs (K1's plain version run in float32): a
# rounding to bf16 may land either side
KERNEL_F32_ATOL = 2e-5
KERNEL_F32_REL_L2 = 1e-5  # K3/K4 sums over up to 3.1M elements
KERNEL_BF16_REL_L2 = 1e-2
# K3 (B, side, C) at its edges: one sample to the recipe's 16, 7x7 and
# 31x31 (whose last tile holds one position at 768 channels), one vector of
# channels (256 positions a tile) and the heads' 768
K3_EDGES = tuple((b, s, c) for b in (1, 3, 9, 16) for s in (7, 16, 31) for c in (8, 768))
# the recipe step's LayerNormSpatial sites by side (models/adapter_heads.py):
# three at 16x16 in each of the three 16x16 teachers' heads, one each at
# 16x16, 31x31 and 64x64 in SAM's and Depth-Anything's
LN_SITES = {16: 11, 31: 2, 64: 2}
# the largest T whose float32 K2 passes fit a block's shared memory, by head
# dim (csrc/mha_bwd.cu smem_bytes_f32 within 227 KB); every other head dim
# takes every T <= 256
K2_F32_MAX_T = {112: 240, 128: 216}
# K2 over every head dim it takes and the edges of its 8-key (8-query) tiles,
# its 16-row warps and its limit (256)
K2_SWEEP_T = (1, 8, 15, 16, 17, 63, 64, 65, 130, 197, 255, 256)
# K1 over every head dim it takes and the edges of its key chunks (64; bf16),
# of its row blocks (64 rows; float32: 128 at hd <= 64, 64 above), of its
# 8-key tiles and 16-row groups (float32) and of its limit (256)
K1_SWEEP_T = (1, 15, 16, 17, 63, 64, 65, 128, 129, 197, 204, 255, 256)
# K7-K9 take any T: the sweep's token counts span 1 to 13 tiles of 64
FLASH_SWEEP_T = (1, 17, 130, 257, 785)
# and float32 K9/K8 (3xTF32) also at the edges of their 16-row groups and
# 64-row tiles
FLASH_F32_EDGE_T = (15, 16, 63, 64, 65)
# and bf16 K7, K9 and K8 (wgmma) at the edges of their 128-row blocks
FLASH_BF16_EDGE_T = (127, 128, 129, 255, 256)
# 448² uint8 images without resize: 28² patches and the CLS token
BIG_IMAGE, BIG_T = 448, 1 + (448 // 16) ** 2
BIG_BATCH, BIG_TRAIN_BATCH = 16, 4
# the whole model, kernel path vs plain attention path, float32: 12 blocks
# and the heads, sums in another order
MODEL_F32_ATOL = 1e-3
# bf16 model vs float32 model, relative L2 over the backbone tokens
MODEL_BF16_REL_L2 = 5e-2
# training: one step, kernel path vs plain path, float32: loss rtol, and
# each gradient's relative L2 (ReLUs of the head ladders flip where a
# pre-activation is within rounding of 0)
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_REL_L2 = 5e-3
# bf16-compute gradients against float32 ones, relative L2 over all of
# them: the kernel path may be no further off than this many times the plain
# path (bf16 rounds at the same places on both; the sums' order differs)
TRAIN_BF16_GRAD_FACTOR = 1.25
# the recipe's float32 step, kernel path vs plain path: the loss differs
# only in the fused sums' order (the attention is the same fast_math code
# on both paths)
RECIPE_LOSS_RTOL = 1e-5
# fused preprocessing vs the unfused model, forward_feature tokens in
# float32: the JAX package's own bound for the same comparison
# (tests/test_fused_preprocessing.py). The fused path skips the PIL
# inter-pass uint8 rounding, which alone moves the tokens ~1.7% (relative
# L2, mse ~3e-4 of a mean square of 1, Theia-tiny on CPU at any depth); bf16
# adds its own rounding on top, so the comparison runs in float32
FUSED_PREPROCESSING_MSE = 5e-4
# K5 against its plain version: float32 sums in another order, within
# this fraction of the sum of the terms' magnitudes (log2(D) roundings of
# 6e-8 each is ~1.2e-6 at D = 2^20); K6 computes each element in the plain
# version's order: float32 relative L2 1e-6, bf16 as the other kernels
LOSS_SUMS_REL = 1e-5
LOSS_DP_F32_REL_L2 = 1e-6
LOSS_SWEEP_D = (1, 127, 1024, 4096 * 32)
TRAIN_BATCH = 16
TRAIN_STEPS = 20
FLASH_TRAIN_STEPS = 10
# the recipe, theia_tpu/configs/training/frame_level.yaml
BASE_LR, BASE_BATCH, BASE_WORLD, WARMUP_STEPS = 2e-3, 64, 8, 2
# the training runtime (train_from_config) on synthetic cddsv shards at the
# teachers' real sizes: 6 steps of 16 from 96 samples, an async save at step 3
# and the blocking one at step 6, one eval step (16 val samples at the
# config's eval ratio of 0.1 give 2, one batch); then a resume to 12
RUNTIME_TRAIN, RUNTIME_VAL, RUNTIME_STEPS = 96, 16, 6
RUNTIME_OVERRIDES = ("model/backbone=deit_base", "training/target_models=cddsv", "dataset.dataset_ratio=1.0",
                     f"training.batch_size={TRAIN_BATCH}", "logging.save_ckpt_interval=3",
                     "logging.log_interval=2")
# JAX's TPU flash attention library, whose three Pallas kernels K7-K9 replace
FLASH_LIBRARY = "jax/experimental/pallas/ops/tpu/flash_attention.py"
# the H100 SXM's published peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TF32_FLOPS = 495e12  # on the tensor cores; a 3xTF32 product issues three


def rel_l2(got: torch.Tensor | np.ndarray, want: torch.Tensor | np.ndarray) -> float:
    got, want = (torch.as_tensor(x).double() for x in (got, want))
    return float((got - want).norm() / want.norm())


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def bound_ms(nbytes: float, flops: float, dtype: torch.dtype) -> tuple[float, str]:
    """The least time for the work: bytes over HBM rate or operations over peak."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def packed_qkv(b: int, t: int, dtype: torch.dtype, gen: torch.Generator) -> tuple[torch.Tensor, ...]:
    """q, k, v [B, T, 12, 64] as the encoder hands them to the kernels: views
    into one packed QKV projection [B, T, 3*768]."""
    qkv = torch.randn(b, t, 3 * HEADS * HEAD_DIM, device="cuda", generator=gen).to(dtype)
    return tuple(y.view(b, t, HEADS, HEAD_DIM) for y in qkv.split(HEADS * HEAD_DIM, dim=-1))


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, f32_atol=None) -> float:
    """Max abs error of ``got`` against ``want``; raise past the stated tolerance."""
    err = float((got.float() - want.float()).abs().max())
    rel = rel_l2(got.float(), want.float())
    if dtype == torch.float32 and f32_atol is not None:
        ok, limit = err <= f32_atol, f"atol {f32_atol}"
    else:
        limit_v = KERNEL_BF16_REL_L2 if dtype == torch.bfloat16 else KERNEL_F32_REL_L2
        ok, limit = rel < limit_v, f"rel_l2 < {limit_v}"
    print(f"  {name}: max_abs_err {err:.3e}, rel_l2 {rel:.3e} ({limit})")
    check(ok, f"{name} disagrees with its plain version")
    return err


def ln_inputs(b: int, c: int, s: int, dtype: torch.dtype, gen: torch.Generator):
    """x, g [B, C, S, S] in channels_last memory, weight (C, S, S) float32, and
    the forward's float32 mean and r."""
    from theia_tpu_torch.ops import ln_pallas

    x = (torch.randn(b, c, s, s, device="cuda", generator=gen) * 2 + 1).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    g = torch.randn(b, c, s, s, device="cuda", generator=gen).to(dtype).contiguous(memory_format=torch.channels_last)
    w = torch.randn(c, s, s, device="cuda", generator=gen)
    mean, r = ln_pallas.ln_spatial_stats(x, 1e-5)
    return x, g, w, mean, r


def compare_kernels(attention, ln_pallas) -> dict:
    """Phase 3: every kernel against its plain version; the max abs errors."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    errors = {}
    print("phase 3: kernels against their plain versions")
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b in (1, 64):
            for t in (197, 204):
                q, k, v = packed_qkv(b, t, dtype, gen)
                got = attention.mha_fwd(q, k, v)
                torch.cuda.synchronize()
                want = attention.mha_fwd_plain(*(x.float() for x in (q, k, v)))
                errors[("mha_fwd", dtype, b, t)] = compare(
                    f"K1 mha_fwd {dn} [{b},{t},12,64]", got, want, dtype, KERNEL_F32_ATOL)
        for b in (1, 16):
            for t in (197, 204):
                q, k, v = packed_qkv(b, t, dtype, gen)
                do = torch.randn(b, t, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
                got = attention.mha_bwd(q, k, v, do)
                torch.cuda.synchronize()
                want = attention.mha_bwd_plain(q, k, v, do)
                errors[("mha_bwd", dtype, b, t)] = compare(
                    f"K2 mha_bwd {dn} [{b},{t},12,64]", got, want, dtype, KERNEL_F32_ATOL)
    # K1 over every head dim it takes and the edges of T, heads as views of a packed projection
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        for hd in range(16, 129, 16):
            for t in K1_SWEEP_T:
                qkv = torch.randn(2, t, 3 * 2 * hd, device="cuda", generator=gen).to(dtype)
                q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
                got = attention.mha_fwd(q, k, v).float()
                want = attention.mha_fwd_plain(*(x.float() for x in (q, k, v)))
                err = float((got - want).abs().max()) if dtype == torch.float32 else rel_l2(got, want)
                worst[dtype] = max(worst[dtype], err)
    print(f"  K1 mha_fwd [2, T, 2, hd], hd 16..128 x T in {K1_SWEEP_T}: float32 worst max_abs_err "
          f"{worst[torch.float32]:.3e} (atol {KERNEL_F32_ATOL}), bf16 worst rel_l2 {worst[torch.bfloat16]:.3e} "
          f"(< {KERNEL_BF16_REL_L2})")
    check(worst[torch.float32] <= KERNEL_F32_ATOL and worst[torch.bfloat16] < KERNEL_BF16_REL_L2,
          "K1 disagrees with its plain version in the shape sweep")
    # scores spread over hundreds: some p = exp(S - max) fall below 2^-90, where
    # the bf16 kernel's rows take the IEEE division (csrc/mha_fwd.cu div_rn)
    wide = 0.0
    for hd in (64, 128):
        for t in (197, 256):
            qkv = torch.randn(2, t, 3 * 2 * hd, device="cuda", generator=gen)
            qkv[..., : 2 * hd] *= 40
            q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(torch.bfloat16).split(2 * hd, dim=-1))
            wide = max(wide, rel_l2(attention.mha_fwd(q, k, v).float(),
                                    attention.mha_fwd_plain(q.float(), k.float(), v.float())))
    print(f"  K1 mha_fwd bf16 [2, 197|256, 2, 64|128], scores x 40 (p below 2^-90): worst rel_l2 {wide:.3e} "
          f"(< {KERNEL_BF16_REL_L2})")
    check(wide < KERNEL_BF16_REL_L2, "K1 disagrees with its plain version where probabilities vanish")
    # float32: integer Q and K spread the scores over hundreds (p below 2^-90,
    # where the kernel's rows take the IEEE division) and keep S exact in
    # both versions (3xTF32 and the plain product; the scale 1/4 or 1/8 is a
    # power of two), so that only the softmax's roundings differ
    wide = 0.0
    for hd in (16, 64):
        for t in (197, 256):
            qk = torch.randint(-8, 9, (2, t, 2 * 2 * hd), device="cuda", generator=gen).float()
            qkv = torch.cat([qk, torch.randn(2, t, 2 * hd, device="cuda", generator=gen)], dim=-1)
            q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
            wide = max(wide, float((attention.mha_fwd(q, k, v) - attention.mha_fwd_plain(q, k, v)).abs().max()))
    print(f"  K1 mha_fwd float32 [2, 197|256, 2, 16|64], integer Q and K (p below 2^-90): worst max_abs_err "
          f"{wide:.3e} (atol {KERNEL_F32_ATOL})")
    check(wide <= KERNEL_F32_ATOL, "K1 float32 disagrees with its plain version where probabilities vanish")
    # K2 over every head dim it takes and the edges of T, heads as views of a packed projection
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype in worst:
        for hd in range(16, 129, 16):
            for t in K2_SWEEP_T:
                qkv = torch.randn(2, t, 3 * 2 * hd, device="cuda", generator=gen).to(dtype)
                q, k, v = (y.view(2, t, 2, hd) for y in qkv.split(2 * hd, dim=-1))
                do = torch.randn(2, t, 2, hd, device="cuda", generator=gen).to(dtype)
                if dtype == torch.float32 and t > K2_F32_MAX_T.get(hd, t):
                    try:  # past the float32 passes' shared memory: the wrapper must raise
                        attention.mha_bwd(q, k, v, do)
                    except RuntimeError:
                        continue
                    raise AssertionError(f"K2 float32 took [2,{t},2,{hd}], past its shared memory")
                got, want = attention.mha_bwd(q, k, v, do).float(), attention.mha_bwd_plain(q, k, v, do).float()
                err = float((got - want).abs().max()) if dtype == torch.float32 else rel_l2(got, want)
                worst[dtype] = max(worst[dtype], 0.0 if want.norm() == 0 else err)
    print(f"  K2 mha_bwd [2, T, 2, hd], hd 16..128 x T in {K2_SWEEP_T}: float32 worst max_abs_err "
          f"{worst[torch.float32]:.3e} (atol {KERNEL_F32_ATOL}), bf16 worst rel_l2 {worst[torch.bfloat16]:.3e} "
          f"(< {KERNEL_BF16_REL_L2})")
    check(worst[torch.float32] <= KERNEL_F32_ATOL and worst[torch.bfloat16] < KERNEL_BF16_REL_L2,
          "K2 disagrees with its plain version in the shape sweep")
    # the same for K2 bf16, whose two passes take the IEEE division where a p
    # falls below 2^-90 (csrc/mha_bwd.cu, div_rn)
    wide = 0.0
    for hd in (64, 128):
        for t in (197, 256):
            qkv = torch.randn(2, t, 3 * 2 * hd, device="cuda", generator=gen)
            qkv[..., : 2 * hd] *= 40
            q, k, v = (y.view(2, t, 2, hd) for y in qkv.to(torch.bfloat16).split(2 * hd, dim=-1))
            do = torch.randn(2, t, 2, hd, device="cuda", generator=gen).to(torch.bfloat16)
            wide = max(wide, rel_l2(attention.mha_bwd(q, k, v, do).float(),
                                    attention.mha_bwd_plain(q, k, v, do).float()))
    print(f"  K2 mha_bwd bf16 [2, 197|256, 2, 64|128], scores x 40 (p below 2^-90): worst rel_l2 {wide:.3e} "
          f"(< {KERNEL_BF16_REL_L2})")
    check(wide < KERNEL_BF16_REL_L2, "K2 disagrees with its plain version where probabilities vanish")
    cases = [(torch.bfloat16, s) for s in (16, 31, 64)] + [(torch.float32, 64)]
    for dtype, s in cases:
        dn = str(dtype).split(".")[-1]
        x, g, w, mean, r = ln_inputs(16, 768, s, dtype, gen)
        got = ln_pallas.ln_bwd_stats(x, w, mean, r, g)
        torch.cuda.synchronize()
        want = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
        errs = [compare(f"K3 ln_bwd_stats {dn} [16,768,{s},{s}] {n}", a, bb, torch.float32)
                for n, a, bb in zip(("s1", "s2", "dw", "db"), got, want)]
        errors[("ln_bwd_stats", dtype, s)] = max(errs)
        dx = ln_pallas.ln_bwd_dx(x, w, mean, r, g, want[0], want[1])
        torch.cuda.synchronize()
        errors[("ln_bwd_dx", dtype, s)] = compare(
            f"K4 ln_bwd_dx {dn} [16,768,{s},{s}]", dx, ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, *want[:2]), dtype)
    check_ln_bwd_stats_edges(ln_pallas, gen)
    return errors


def check_ln_bwd_stats_edges(ln_pallas, gen: torch.Generator) -> None:
    """K3 over its edges, against the plain version on the same inputs in
    float64 (each output within rel L2 KERNEL_F32_REL_L2, dw and db
    contiguous (C, H, W)), bit-identical on a second call; bit-identical
    over 50 calls back to back (its ticket counters reset themselves) and
    over calls in flight on two streams at once (each stream has its own
    counters); and one device operation a call (torch.profiler: no copy,
    memset or second kernel)."""
    from theia_tpu_torch.tools.timing import device_ops

    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for b, s, c in K3_EDGES:
            x, g, w, mean, r = ln_inputs(b, c, s, dtype, gen)
            got = ln_pallas.ln_bwd_stats(x, w, mean, r, g)
            want = ln_pallas.ln_bwd_stats_plain(*(t.double() for t in (x, w, mean, r, g)))
            errs = [rel_l2(a, bb) for a, bb in zip(got, want)]
            worst = max(worst, *errs)
            check(max(errs) < KERNEL_F32_REL_L2,
                  f"K3 disagrees with its plain version at [{b},{c},{s},{s}] {dtype}: rel_l2 s1/s2/dw/db {errs}")
            check(all(t.shape == w.shape and t.is_contiguous() for t in got[2:]),
                  "K3's dw, db are not contiguous (C, H, W)")
            again = ln_pallas.ln_bwd_stats(x, w, mean, r, g)
            check(all(torch.equal(a, bb) for a, bb in zip(got, again)), f"K3's two calls differ at [{b},{c},{s},{s}]")
    print(f"  K3 ln_bwd_stats over B x S x C = (1, 3, 9, 16) x (7², 16², 31²) x (8, 768), bf16 and float32, "
          f"against the plain version in float64: worst rel_l2 {worst:.3e} (< {KERNEL_F32_REL_L2}); dw, db "
          f"contiguous (C, H, W); bit-identical on two calls")
    x, g, w, mean, r = ln_inputs(16, 768, 16, torch.bfloat16, gen)
    first = ln_pallas.ln_bwd_stats(x, w, mean, r, g)
    runs = [ln_pallas.ln_bwd_stats(x, w, mean, r, g) for _ in range(50)]
    check(all(torch.equal(a, bb) for run in runs for a, bb in zip(first, run)), "K3's 50 calls back to back differ")
    torch.cuda.synchronize()
    streams, runs = [torch.cuda.Stream() for _ in range(2)], []
    for _ in range(20):
        for stream in streams:
            with torch.cuda.stream(stream):
                runs.append(ln_pallas.ln_bwd_stats(x, w, mean, r, g))
    torch.cuda.synchronize()
    check(all(torch.equal(a, bb) for run in runs for a, bb in zip(first, run)),
          "K3's calls on two streams at once differ from one stream's")
    ops = device_ops(lambda: ln_pallas.ln_bwd_stats(x, w, mean, r, g))
    print(f"  K3 ln_bwd_stats bf16 [16,768,16,16]: 50 calls back to back and 40 on two streams at once "
          f"bit-identical; device operations a call (torch.profiler): {ops}")
    check(len(ops) == 1 and next(iter(ops)).startswith("ln_bwd_stats_sm90") and next(iter(ops.values())) == 1.0,
          f"a K3 call is not one kernel launch: {ops}")


def flash_case(attention, b: int, t: int, h: int, hd: int, dtype: torch.dtype, gen: torch.Generator) -> dict:
    """K7, K9 and K8 once on q, k, v as views of one packed QKV projection,
    and each one's plain version on the same inputs (the backward ones fed
    the kernels' O, lse and di): {output name: (kernel's, plain's)}."""
    qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=gen).to(dtype)
    q, k, v = (y.view(b, t, h, hd) for y in qkv.split(h * hd, dim=-1))
    do = torch.randn(b, t, h, hd, device="cuda", generator=gen).to(dtype)
    o, lse = attention.flash_fwd(q, k, v)
    dq, di = attention.flash_dq(q, k, v, o, lse, do)
    dk, dv = attention.flash_dkv(q, k, v, lse, di, do)
    torch.cuda.synchronize()
    want_o, want_lse = attention.flash_fwd_plain(q, k, v)
    want_dq, want_di = attention.flash_dq_plain(q, k, v, o, lse, do)
    want_dk, want_dv = attention.flash_dkv_plain(q, k, v, lse, di, do)
    return {"flash_fwd": (o, want_o), "lse": (lse, want_lse), "flash_dq": (dq, want_dq), "di": (di, want_di),
            "flash_dkv": (torch.stack([dk, dv]), torch.stack([want_dk, want_dv]))}


def flash_error(got: torch.Tensor, want: torch.Tensor, dtype: torch.dtype, stat: bool) -> tuple[float, float, bool]:
    """(max abs error, relative L2, within tolerance) of a flash output: a
    float32 result within KERNEL_F32_ATOL, a bf16 one within
    KERNEL_BF16_REL_L2 or, where the exact result is 0 and both sides hold
    float32 rounding noise (dQ and dK at T = 1), within KERNEL_F32_ATOL;
    lse and di (float32 row statistics, whatever the input dtype) within
    KERNEL_F32_REL_L2."""
    err = float((got.float() - want.float()).abs().max())
    rel = rel_l2(got.float(), want.float()) if want.float().norm() > 0 else err
    if stat:
        return err, rel, rel <= KERNEL_F32_REL_L2
    if dtype == torch.float32:
        return err, rel, err <= KERNEL_F32_ATOL
    return err, rel, rel < KERNEL_BF16_REL_L2 or err <= KERNEL_F32_ATOL


def compare_flash_kernels(attention) -> dict:
    """Phase 3, K7, K9 and K8 against their plain versions: at the serving and
    training shapes [1|64, 197|204, 12, 64] and [1|16, 197|204, 12, 64], at
    448² images' [16, 785, 12, 64], and over head dims 16..128 x
    FLASH_SWEEP_T (float32 also FLASH_F32_EDGE_T, bf16 FLASH_BF16_EDGE_T);
    float32 and bf16; then bf16 K7-K9's hard cases (``flash_bf16_hard_cases``).
    The max abs errors."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    errors = {}
    shapes = [(1, 197), (64, 197), (1, 204), (64, 204), (16, 197), (16, 204), (BIG_BATCH, BIG_T)]
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[-1]
        for b, t in shapes:
            res = flash_case(attention, b, t, HEADS, HEAD_DIM, dtype, gen)
            line = []
            for name, (got, want) in res.items():
                err, rel, ok = flash_error(got, want, dtype, name in ("lse", "di"))
                check(ok, f"{name} {dn} [{b},{t},12,64] disagrees with its plain version: max abs {err:.3e}, "
                           f"rel_l2 {rel:.3e}")
                errors[(name, dtype, b, t)] = err
                line.append(f"{name} {err:.2e}/{rel:.2e}")
            print(f"  K7/K9/K8 flash {dn} [{b},{t},12,64] (max_abs_err/rel_l2): {', '.join(line)}")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for hd in range(16, 129, 16):
            for t in FLASH_SWEEP_T + (FLASH_F32_EDGE_T if dtype == torch.float32 else FLASH_BF16_EDGE_T):
                for name, (got, want) in flash_case(attention, 2, t, 2, hd, dtype, gen).items():
                    err, rel, ok = flash_error(got, want, dtype, name in ("lse", "di"))
                    check(ok, f"{name} {dtype} [2,{t},2,{hd}] disagrees with its plain version: max abs {err:.3e}, "
                               f"rel_l2 {rel:.3e}")
                    key = (name, dtype)
                    # bf16: a case within the absolute floor (exact result 0) counts as 0
                    bad = err if dtype == torch.float32 else (rel if err > KERNEL_F32_ATOL else 0.0)
                    worst[key] = max(worst.get(key, 0.0), bad)
    print(f"  K7/K9/K8 flash [2, T, 2, hd], hd 16..128 x T in {FLASH_SWEEP_T} (float32 also {FLASH_F32_EDGE_T}, "
          f"bf16 {FLASH_BF16_EDGE_T}): "
          "float32 worst max_abs_err " +
          ", ".join(f"{n} {worst[(n, torch.float32)]:.3e}" for n in ("flash_fwd", "flash_dq", "flash_dkv")) +
          f" (atol {KERNEL_F32_ATOL}); bf16 worst rel_l2 " +
          ", ".join(f"{n} {worst[(n, torch.bfloat16)]:.3e}" for n in ("flash_fwd", "flash_dq", "flash_dkv")) +
          f" (< {KERNEL_BF16_REL_L2}); lse, di within rel_l2 {KERNEL_F32_REL_L2}")
    flash_bf16_hard_cases(attention, gen)
    return errors


def flash_bf16_hard_cases(attention, gen: torch.Generator) -> None:
    """bf16 K7, K9 and K8 at [2, 785, 2, 64|128] where the online softmax
    works hardest and where P and dS are concentrated, each held to its
    plain version on the kernels' O, lse and di (O, dQ, dK and dV rel_l2 <
    KERNEL_BF16_REL_L2, lse and di within KERNEL_F32_REL_L2): "rising max",
    K scaled up along the keys (1x to ~12x), so that each 64-key tile raises
    the row maxima and rescales O and l; "scores x 40", Q scaled by 40, so
    that most p underflow to 0."""
    worst = {}
    for hd in (64, 128):
        for case in ("rising max", "scores x 40"):
            qkv = torch.randn(2, BIG_T, 3 * 2 * hd, device="cuda", generator=gen)
            if case == "rising max":
                qkv[..., 2 * hd: 4 * hd] *= torch.linspace(1, BIG_T / 64, BIG_T, device="cuda")[None, :, None]
            else:
                qkv[..., : 2 * hd] *= 40
            q, k, v = (y.view(2, BIG_T, 2, hd) for y in qkv.to(torch.bfloat16).split(2 * hd, dim=-1))
            do = torch.randn(2, BIG_T, 2, hd, device="cuda", generator=gen).to(torch.bfloat16)
            o, lse = attention.flash_fwd(q, k, v)
            dq, di = attention.flash_dq(q, k, v, o, lse, do)
            dk, dv = attention.flash_dkv(q, k, v, lse, di, do)
            want_o, want_lse = attention.flash_fwd_plain(q, k, v)
            want_dq, want_di = attention.flash_dq_plain(q, k, v, o, lse, do)
            want_dkv = torch.stack(attention.flash_dkv_plain(q, k, v, lse, di, do))
            errs = {name: rel_l2(got.float(), want.float()) for name, got, want in (
                ("O", o, want_o), ("lse", lse, want_lse), ("dQ", dq, want_dq), ("di", di, want_di),
                ("dK/dV", torch.stack([dk, dv]), want_dkv))}
            ok = all(errs[n] < KERNEL_BF16_REL_L2 for n in ("O", "dQ", "dK/dV"))
            check(ok and errs["lse"] <= KERNEL_F32_REL_L2 and errs["di"] <= KERNEL_F32_REL_L2,
                  f"K7-K9 bf16 [2,{BIG_T},2,{hd}] {case} disagree with their plain versions: " +
                  ", ".join(f"{n} rel_l2 {e:.3e}" for n, e in errs.items()))
            worst[case] = {n: max(worst.get(case, {}).get(n, 0.0), e) for n, e in errs.items()}
    print(f"  K7/K9/K8 flash bf16 [2, {BIG_T}, 2, 64|128]: " +
          "; ".join(f"{case} worst rel_l2 " + ", ".join(f"{n} {e:.3e}" for n, e in w.items())
                    for case, w in worst.items()) +
          f" (O, dQ, dK/dV < {KERNEL_BF16_REL_L2}; lse, di <= {KERNEL_F32_REL_L2})")


def compare_loss_kernels(fused_loss, teacher_dims: list[int]) -> dict:
    """Phase 3, K5 and K6 against their plain versions at the teachers' [16,
    D] (bf16 pred with float32 target, and float32 both) and over a sweep
    of B and D; the max abs errors at the recipe's SAM map."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    bf16, f32 = torch.bfloat16, torch.float32
    cases = [(TRAIN_BATCH, d, pdt, f32) for d in teacher_dims for pdt in (bf16, f32)]
    cases += [(b, d, pdt, tdt) for b in (1, TRAIN_BATCH) for d in LOSS_SWEEP_D
              for pdt, tdt in ((bf16, f32), (f32, f32), (bf16, bf16))]
    errors, worst = {}, {"sums": 0.0, "dp_f32": 0.0, "dp_bf16": 0.0}
    bitwise = True
    for b, d, pdt, tdt in cases:
        p = torch.randn(b, d, device="cuda", generator=gen).to(pdt)
        t = torch.randn(b, d, device="cuda", generator=gen).to(tdt)
        g = torch.randn(b, 5, device="cuda", generator=gen)
        sums, dp = fused_loss.loss_sums_fwd(p, t), fused_loss.loss_sums_bwd(p, t, g)
        torch.cuda.synchronize()
        want = fused_loss.loss_sums_plain(p, t)
        scale = fused_loss.loss_sums_plain(p.abs(), -t.abs()).abs()  # the sums of the terms' magnitudes
        rel = float(((sums - want).abs() / scale.clamp_min(1e-30)).max())
        want_dp = fused_loss.loss_sums_bwd_plain(p, t, g)
        dp_rel = rel_l2(dp.float(), want_dp.float())
        bitwise = bitwise and torch.equal(dp, want_dp)
        worst["sums"] = max(worst["sums"], rel)
        worst["dp_f32" if pdt == f32 else "dp_bf16"] = max(worst["dp_f32" if pdt == f32 else "dp_bf16"], dp_rel)
        errors[("loss_sums_fwd", b, d, pdt, tdt)] = float((sums - want).abs().max())
        errors[("loss_sums_bwd", b, d, pdt, tdt)] = float((dp.float() - want_dp.float()).abs().max())
        if b == TRAIN_BATCH and d in teacher_dims and tdt == f32:
            dn = f"{str(pdt).split('.')[-1]}/{str(tdt).split('.')[-1]}"
            print(f"  K5 loss_sums_fwd {dn} [{b},{d}]: max_abs_err {errors[('loss_sums_fwd', b, d, pdt, tdt)]:.3e}, "
                  f"worst |err| / sum of |terms| {rel:.3e} (< {LOSS_SUMS_REL}); K6 loss_sums_bwd max_abs_err "
                  f"{errors[('loss_sums_bwd', b, d, pdt, tdt)]:.3e}, rel_l2 {dp_rel:.3e}")
    print(f"  K5/K6 over B in (1, {TRAIN_BATCH}) x D in {LOSS_SWEEP_D}, bf16|f32 pred x f32|bf16 target, and the "
          f"teachers: worst sums |err| / sum of |terms| {worst['sums']:.3e} (< {LOSS_SUMS_REL}); d pred rel_l2 "
          f"float32 {worst['dp_f32']:.3e} (< {LOSS_DP_F32_REL_L2}), bf16 {worst['dp_bf16']:.3e} "
          f"(< {KERNEL_BF16_REL_L2}); d pred bit for bit equal to the plain version in every case: {bitwise}")
    check(worst["sums"] < LOSS_SUMS_REL, "K5 disagrees with its plain version")
    check(worst["dp_f32"] < LOSS_DP_F32_REL_L2 and worst["dp_bf16"] < KERNEL_BF16_REL_L2,
          "K6 disagrees with its plain version")
    return errors


def loss_and_grads(model, images, targets):
    """One step's loss and gradients (the train step's loss, no update)."""
    from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
    from theia_tpu_torch.train.step import prepare_targets

    loss = main_loss_from_terms(get_loss(model(images), prepare_targets(targets)), "cos_l1")
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return float(loss.detach()), dict(zip(names, grads))


def training_runtime(card: str, teachers: list[str], reset_counts, read_counts, expected: dict) -> dict:
    """Phase 6b: ``train.loop.train_from_config`` at the production recipe on
    synthetic shards, a restore checked tensor for tensor against the file,
    and a resume. Returns the launch counts of the first call."""
    import contextlib
    import io
    import os
    import shutil
    import tempfile

    from theia_tpu_torch.config import load_config
    from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES
    from theia_tpu_torch.train import loop
    from theia_tpu_torch.train.checkpoint import restore_checkpoint
    from theia_tpu_torch.train.state import TrainState

    sizes = {t: MODEL_FEATURE_SIZES[t] for t in teachers}
    sample_bytes = 224 * 224 * 3 + sum(2 * math.prod(s) for s in sizes.values())
    tmp = tempfile.mkdtemp(prefix="theia_runtime_")
    try:
        def config(epochs: int):
            return load_config("train_rvfm_imagenet", [
                *RUNTIME_OVERRIDES, f"dataset.dataset_root={tmp}", f"training.epochs={epochs}",
                f"logging.model_path={tmp}/ckpt", f"logging.log_path={tmp}/logs"])

        cfg = config(1)
        # the student at step 0, as the loop builds it; the restore below lands in it
        model = loop.build_model(cfg, "cuda")
        init = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = TrainState.create(dict(model.named_parameters()), loop.build_optimizer(cfg, 0.0))
        ckpt_bytes = sum(t.numel() * t.element_size() for tree in (state.params, state.opt_state.mu,
                                                                    state.opt_state.nu) for t in tree.values())
        need = sample_bytes * (RUNTIME_TRAIN + RUNTIME_VAL) + 5 * ckpt_bytes + (1 << 30)
        free = shutil.disk_usage(tmp).free
        print(f"phase 6b, the training runtime: {MODEL} at the recipe through train_from_config; {tmp}: "
              f"{free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed ({RUNTIME_TRAIN + RUNTIME_VAL} samples of "
              f"{sample_bytes / 1e6:.2f} MB, 5 checkpoints of {ckpt_bytes / 1e9:.2f} GB, 1 GiB spare)")
        check(free >= need, f"{tmp} has {free} bytes free, the phase needs {need}")
        t0 = time.perf_counter()
        generate_synthetic_dataset(tmp, feature_models=sizes, n_train=RUNTIME_TRAIN, n_val=RUNTIME_VAL, seed=0)
        print(f"  synthetic cddsv shards (224² uint8 images, bf16 features at the teachers' sizes): "
              f"{time.perf_counter() - t0:.1f} s")

        def train(cfg) -> tuple[dict, dict, list[str]]:
            """One train_from_config call with the launch counts set to 0 just
            before and read just after; its own printing is kept apart."""
            out = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(out):
                summary = loop.train_from_config(cfg)
            torch.cuda.synchronize()
            counts = read_counts()
            return summary, counts, [ln for ln in out.getvalue().splitlines() if ln.startswith("[theia_tpu_torch]")]

        def report(label: str, summary: dict, counts: dict) -> None:
            t = summary["timing"]
            blocked = sum(b for _, b, _ in t["saves"])
            ev = summary["eval"]
            print(f"  {label}: step {summary['step']}; eval cos {ev['avg_eval_cos_loss']:.6f}, l1 "
                  f"{ev['avg_eval_l1_loss']:.6f}, mse {ev['avg_eval_mse_loss']:.6f}; train loss "
                  f"{summary['train']['loss']:.6f}; launches {counts}, expected {expected}")
            print(f"  {label}: loop wall {t['wall_s']:.3f} s for {t['steps']} steps + 1 eval + "
                  f"{len(t['saves'])} saves: {t['wall_s'] / t['steps'] * 1e3:.1f} ms a step, "
                  f"{t['images'] / t['wall_s']:.1f} images/s ({(t['wall_s'] - blocked) / t['steps'] * 1e3:.1f} ms "
                  f"a step less the {blocked:.3f} s save() blocked); waiting in the loaders' next() "
                  f"{t['loader_wait_s']:.3f} s, {100 * t['loader_wait_s'] / t['wall_s']:.1f}% of the wall ({card})")
            for step, blocked_s, write_s in t["saves"]:
                print(f"  {label}: save at step {step}: save() blocked {blocked_s:.3f} s, its background write "
                      f"(torch.save, fsync, rename) {write_s:.3f} s ({card})")
            check(all(math.isfinite(v) for v in ev.values()), f"{label}: an eval loss is not finite")
            check(counts == expected, f"{label}: kernel launch counts are off")

        summary, counts, lines = train(cfg)
        report("call 1 (epochs=1)", summary, counts)
        check(summary["step"] == RUNTIME_STEPS, f"call 1 ended at step {summary['step']}")
        check([s for s, _, _ in summary["timing"]["saves"]] == [3, 6], "call 1 saved at other steps than 3 and 6")
        (log,) = Path(tmp, "logs").glob("*.metrics.jsonl")
        rows = [json.loads(ln) for ln in log.read_text().splitlines()]
        train_steps = [r["step"] for r in rows if "loss" in r]
        eval_steps = [r["step"] for r in rows if "avg_eval_cos_loss" in r]
        print(f"  JSONL log {log.name}: train rows at steps {train_steps}, eval rows at {eval_steps}")
        check(train_steps == [2, 4, 6] and eval_steps == [6] and len(rows) == 4, "the JSONL log's steps are off")

        # restore step 6 into the state built before call 1, and hold it to the file
        ckpt_dir = summary["ckpt_dir"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        restore_checkpoint(ckpt_dir, state, step=RUNTIME_STEPS)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        saved = torch.load(os.path.join(ckpt_dir, f"{RUNTIME_STEPS}.pt"), map_location="cpu", weights_only=True)
        opt = state.opt_state
        live = {"step": {"": state.step}, "sched_count": {"": opt.sched_count}, "params": state.params,
                "count": opt.count, "mu": opt.mu, "nu": opt.nu}
        differ = [f"{k}.{n}" for k, tree in live.items() for n, t in tree.items()
                  if not torch.equal(t.cpu(), saved[k] if n == "" else saved[k][n])]
        own = dict(model.named_parameters())
        differ += [n for n, p in own.items() if not torch.equal(p.detach().cpu(), saved["params"][n])]
        changed = sum(not torch.equal(own[n], init[n]) for n in init)
        print(f"  restore of step {RUNTIME_STEPS} into a TrainState built on the card as the loop builds it: "
              f"{restore_s:.3f} s ({card}); {sum(len(t) for t in live.values())} tensors and the model's "
              f"{len(own)} parameters against the file: {len(differ)} differ; {changed} of the model's "
              f"{len(own)} parameters moved from step 0; step {int(state.step)}, moments "
              f"{opt.mu[next(iter(opt.mu))].dtype}")
        check(not differ, f"restored tensors differ from the file: {differ[:5]}")
        check(changed > 0 and int(state.step) == RUNTIME_STEPS, "the restore did not reach the model's parameters")
        del model, state, opt, live, own, init, saved
        torch.cuda.empty_cache()

        summary2, counts2, lines2 = train(config(2))
        for ln in lines2:
            print(f"  call 2: {ln}")
        report("call 2 (epochs=2, resumed)", summary2, counts2)
        check(any(f"resuming at step {RUNTIME_STEPS} " in ln for ln in lines2), "call 2 did not resume at step 6")
        check(summary2["step"] == 2 * RUNTIME_STEPS, f"call 2 ended at step {summary2['step']}")
        print(f"  call 2: the loop's own restore {summary2['timing']['restore_s']:.3f} s ({card})")
        return counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import theia_tpu_torch

    here = Path(__file__).resolve().parent
    if Path(theia_tpu_torch.__file__).resolve().parent.parent != here:
        print(f"chip_smoke: theia_tpu_torch not found beside {here}", file=sys.stderr)
        return 1
    from theia_tpu_torch.foundation.common import get_model_feature_size
    from theia_tpu_torch.kernels import build
    from theia_tpu_torch.models import layers, losses as loss_module, vit
    from theia_tpu_torch.models.hub import build_theia, parse_model_name
    from theia_tpu_torch.ops import attention, fused_loss, ln_pallas
    from theia_tpu_torch.serving import Predictor
    from theia_tpu_torch.train.optim import constant_with_warmup, make_optimizer, scaled_lr
    from theia_tpu_torch.train.state import TrainState
    from theia_tpu_torch.train.step import make_eval_step, make_train_step
    from theia_tpu_torch.tools.timing import (cuda_ms, interleaved_ms, ptxas_usage, sdpa_backward, sdpa_forward,
                                              wgmma_serialized)

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
    usage = ptxas_usage(lib_path.with_suffix(".log").read_text())
    for name, line in usage:
        print(f"  ptxas: {name}: {line}")
    usage = dict(usage)
    serialized = wgmma_serialized(lib_path.with_suffix(".log").read_text())
    for name, reason in serialized:
        print(f"  ptxas serialized the wgmma of {name} ({reason})")
    # K1 bf16 at the main path's T = 197: two chunks of 64 keys a warpgroup
    k1 = f"mha_fwd_bf16<{HEAD_DIM},2>"
    k1_blocks = build.load().theia_mha_fwd_bf16_blocks_per_sm(197, HEAD_DIM)
    print(f"  K1 {k1} (T = 197): ptxas {usage.get(k1)}; {k1_blocks} resident blocks per SM "
          "(cudaOccupancyMaxActiveBlocksPerMultiprocessor, 256 threads a block)")
    check(k1 in usage and k1_blocks > 0, f"K1's ptxas line or occupancy query is missing ({k1_blocks})")
    # K1 float32 (3xTF32) at the main path's head dim and T = 197
    k1 = f"mha_fwd_f32<{HEAD_DIM}>"
    threads = ctypes.c_int(0)
    k1_blocks = build.load().theia_mha_fwd_f32_blocks_per_sm(197, HEAD_DIM, ctypes.byref(threads))
    print(f"  K1 {k1} (T = 197): ptxas {usage.get(k1)}; {k1_blocks} resident blocks per SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block)")
    check(k1 in usage and k1_blocks > 0, f"K1 float32's ptxas line or occupancy query is missing ({k1_blocks})")
    # K2 at the main path's head dim and T = 197, its two passes: bf16 (wgmma;
    # the row pass holds 2 chunks of 64 keys a warpgroup there) and float32
    # (3xTF32)
    k2_passes = {"bf16": (f"mha_bwd_rows_bf16<{HEAD_DIM},2>", f"mha_bwd_cols_bf16<{HEAD_DIM}>"),
                 "f32": (f"mha_bwd_rows_f32<{HEAD_DIM}>", f"mha_bwd_cols_f32<{HEAD_DIM}>")}
    for dn, names in k2_passes.items():
        query = getattr(build.load(), f"theia_mha_bwd_{dn}_blocks_per_sm")
        for cols, k2 in enumerate(names):
            threads = ctypes.c_int(0)
            k2_blocks = query(197, HEAD_DIM, cols, ctypes.byref(threads))
            print(f"  K2 {k2} (T = 197): ptxas {usage.get(k2)}; {k2_blocks} resident blocks per SM "
                  f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block)")
            check(k2 in usage and k2_blocks > 0, f"K2's ptxas line or occupancy query is missing ({k2_blocks})")
    # K7, K9 and K8 float32 (3xTF32) at the main path's head dim
    for number, kernel in ((7, f"flash_fwd_f32<{HEAD_DIM}>"), (9, f"flash_dq_f32<{HEAD_DIM}>"),
                           (8, f"flash_dkv_f32<{HEAD_DIM}>")):
        threads = ctypes.c_int(0)
        blocks = build.load().theia_flash_f32_blocks_per_sm(HEAD_DIM, number, ctypes.byref(threads))
        print(f"  K{number} {kernel}: ptxas {usage.get(kernel)}; {blocks} resident blocks per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block)")
        check(kernel in usage and blocks > 0, f"{kernel}'s ptxas line or occupancy query is missing ({blocks})")
    # K7 bf16 (wgmma) at the main path's head dim
    k7 = f"flash_fwd_bf16<{HEAD_DIM}>"
    threads = ctypes.c_int(0)
    blocks = build.load().theia_flash_fwd_bf16_blocks_per_sm(HEAD_DIM, ctypes.byref(threads))
    notes = [reason for name, reason in serialized if name == k7]
    print(f"  K7 {k7}: ptxas {usage.get(k7)}; {blocks} resident blocks per SM "
          f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block); wgmma serialized: "
          f"{'; '.join(notes) or 'no'}")
    check(k7 in usage and blocks > 0, f"{k7}'s ptxas line or occupancy query is missing ({blocks})")
    # K9 and K8 bf16 (wgmma) at the main path's head dim and at the widest
    for number, kernel in ((9, "flash_dq_bf16"), (8, "flash_dkv_bf16")):
        for hd in (HEAD_DIM, 128):
            name = f"{kernel}<{hd}>"
            threads = ctypes.c_int(0)
            blocks = build.load().theia_flash_bwd_bf16_blocks_per_sm(hd, number, ctypes.byref(threads))
            notes = [reason for n, reason in serialized if n == name]
            print(f"  K{number} {name}: ptxas {usage.get(name)}; {blocks} resident blocks per SM "
                  f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block); wgmma "
                  f"serialized: {'; '.join(notes) or 'no'}")
            check(name in usage and blocks > 0, f"{name}'s ptxas line or occupancy query is missing ({blocks})")

    # K3 at the recipe's three sites in bf16 and at 64x64 in float32
    for dtype, side in ((torch.bfloat16, 16), (torch.bfloat16, 31), (torch.bfloat16, 64), (torch.float32, 64)):
        k3 = f"ln_bwd_stats_sm90<{'bf16' if dtype == torch.bfloat16 else 'f32'}>"
        threads, grid = ctypes.c_int(0), ctypes.c_int(0)
        blocks = build.load().theia_ln_bwd_stats_blocks_per_sm(
            side * side, 768, ln_pallas._DTYPE_CODES[dtype], ctypes.byref(threads), ctypes.byref(grid))
        print(f"  K3 {k3} [{TRAIN_BATCH},768,{side},{side}]: ptxas {usage.get(k3)}; {blocks} resident blocks per SM "
              f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor, {threads.value} threads a block), a grid of "
              f"{grid.value}")
        check(k3 in usage and blocks > 0, f"K3's ptxas line or occupancy query is missing ({blocks})")

    # phase 3: kernel vs plain; float32 phases run with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    kernel_errors = compare_kernels(attention, ln_pallas)
    kernel_errors.update(compare_flash_kernels(attention))
    _, teachers = parse_model_name(MODEL)
    teacher_dims = [math.prod(get_model_feature_size(t, keep_spatial=True)) for t in teachers]
    kernel_errors.update(compare_loss_kernels(fused_loss, teacher_dims))

    # phase 4: serving
    t0 = time.perf_counter()
    model = build_theia(MODEL, dtype=torch.float32, generator=torch.Generator().manual_seed(0))
    model_bf16 = build_theia(MODEL, dtype=torch.bfloat16, param_dtype=torch.bfloat16,
                             generator=torch.Generator().manual_seed(0))
    check(next(model.parameters()).is_cuda, "build_theia did not put the model on the GPU")
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
    serve_launches = attention.MHA_FWD_LAUNCHES
    main_s = time.perf_counter() - t0
    batches_per_pass = sum(math.ceil(n / BUCKETS[-1]) for n in REQUESTS)
    expected = 4 * batches_per_pass * model.backbone.cfg.num_layers
    print(f"phase 4, serving: {sum(REQUESTS)} images x 4 passes in {main_s:.1f} s; mha_fwd launches "
          f"{serve_launches}, expected 12 layers x {4 * batches_per_pass} bucket batches = {expected}")
    check(serve_launches == expected, f"mha_fwd launched {serve_launches} times on the main path, expected {expected}")

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
    saved_cfg = vit.BACKBONE_CONFIGS[backbone_name]

    def attention_model(impl: str, **kw):
        """``build_theia`` with the backbone's ``attention_impl`` set to ``impl``."""
        vit.BACKBONE_CONFIGS[backbone_name] = dataclasses.replace(saved_cfg, attention_impl=impl)
        try:
            m = build_theia(MODEL, **kw)
        finally:
            vit.BACKBONE_CONFIGS[backbone_name] = saved_cfg
        check(m.backbone.cfg.attention_impl == impl, f"the model does not use attention_impl={impl!r}")
        return m

    plain_model = attention_model("einsum", dtype=torch.float32)
    plain_model.load_state_dict(model.state_dict())
    plain_ff = Predictor(plain_model, buckets=BUCKETS)
    plain_predict = Predictor(plain_model, buckets=BUCKETS, method="predict")
    plain_feats = [plain_ff(x) for x in requests]
    worst_ff = max(float(np.abs(f - pf).max()) for f, pf in zip(feats, plain_feats))
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
    del plain_ff, plain_predict, preds

    def attention_counts() -> dict:
        return {"mha_fwd": attention.MHA_FWD_LAUNCHES, "mha_bwd": attention.MHA_BWD_LAUNCHES,
                "flash_fwd": attention.FLASH_FWD_LAUNCHES, "flash_dq": attention.FLASH_DQ_LAUNCHES,
                "flash_dkv": attention.FLASH_DKV_LAUNCHES}

    def reset_attention_counts():
        attention.MHA_FWD_LAUNCHES = attention.MHA_BWD_LAUNCHES = 0
        attention.FLASH_FWD_LAUNCHES = attention.FLASH_DQ_LAUNCHES = attention.FLASH_DKV_LAUNCHES = 0

    def forward_only(n_flash: int) -> dict:
        return {"mha_fwd": 0, "mha_bwd": 0, "flash_fwd": n_flash, "flash_dq": 0, "flash_dkv": 0}

    # the same requests through attention_impl="flash" (K7), float32 and bf16, same weights
    flash_model = attention_model("flash", dtype=torch.float32)
    flash_model.load_state_dict(model.state_dict())
    flash_bf16 = attention_model("flash", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    flash_bf16.load_state_dict(model_bf16.state_dict())
    flash_ff, flash_ff_bf16 = Predictor(flash_model, buckets=BUCKETS), Predictor(flash_bf16, buckets=BUCKETS)
    reset_attention_counts()
    t0 = time.perf_counter()
    flash_feats = [flash_ff(x) for x in requests]
    flash_feats_bf16 = [flash_ff_bf16(x) for x in requests]
    counts = attention_counts()
    flash_s = time.perf_counter() - t0
    want = forward_only(2 * batches_per_pass * model.backbone.cfg.num_layers)
    print(f"phase 4, serving through attention_impl=\"flash\": {sum(REQUESTS)} images x 2 passes (float32, bf16) in "
          f"{flash_s:.1f} s; launches {counts}, expected {want}")
    check(counts == want, "flash serving launch counts are off")
    for n, f, fb in zip(REQUESTS, flash_feats, flash_feats_bf16):
        for name, arr in [("flash forward_feature", f), ("flash bf16 forward_feature", fb)]:
            check(arr.shape == (n, 196, 768) and bool(np.isfinite(arr).all()), f"{name}: shape {arr.shape} or values")
    worst_flash = max(float(np.abs(f - pf).max()) for f, pf in zip(flash_feats, plain_feats))
    flash_bf16_err = max(rel_l2(fb, f) for fb, f in zip(flash_feats_bf16, flash_feats))
    print(f"  flash vs plain attention path (float32): forward_feature max_abs {worst_flash:.3e} (atol "
          f"{MODEL_F32_ATOL}); bf16 vs float32: rel_l2 {flash_bf16_err:.3e} (< {MODEL_BF16_REL_L2})")
    check(worst_flash <= MODEL_F32_ATOL, "the flash path disagrees with the plain path")
    check(flash_bf16_err < MODEL_BF16_REL_L2, "bf16 flash forward_feature far from float32")
    del flash_ff, flash_ff_bf16, plain_feats, flash_feats, flash_feats_bf16
    x64 = torch.from_numpy(requests[3][:64]).cuda()
    with torch.inference_mode():
        # ~165 launches a call: too many to hold the stream over, so back-to-back calls
        serve_ms = interleaved_ms({"pallas": lambda: model_bf16.forward_feature(x64),
                                   "flash": lambda: flash_bf16.forward_feature(x64)}, iters=10, hold=False)
    print(f"  forward_feature B=64 bf16 at 224², order pallas, flash, flash, pallas (CUDA events, 10 calls each): "
          f"pallas {serve_ms['pallas']:.3f} ms, flash {serve_ms['flash']:.3f} ms ({card})")

    # uint8 448² images, no resize, interpolated position embeddings: T = 785,
    # past K1's 256, so "pallas" dispatches to the flash kernels as "flash" does
    big = torch.from_numpy(rng.integers(0, 256, (BIG_BATCH, BIG_IMAGE, BIG_IMAGE, 3), dtype=np.uint8)).cuda()
    big_kw = dict(do_resize=False, interpolate_pos_encoding=True)
    plain_bf16 = attention_model("einsum", dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    plain_bf16.load_state_dict(model_bf16.state_dict())
    n_layers = saved_cfg.num_layers
    big_ms = {}
    print(f"phase 4, forward_feature on [{BIG_BATCH},{BIG_IMAGE},{BIG_IMAGE},3] uint8 images, {big_kw} (T = {BIG_T}):")
    with torch.inference_mode():
        want_f32 = plain_model.forward_feature(big, **big_kw)
        want_bf16 = plain_bf16.forward_feature(big, **big_kw)
        for dn, models in (("float32", {"flash": flash_model, "pallas": model, "einsum": plain_model}),
                           ("bf16", {"flash": flash_bf16, "pallas": model_bf16, "einsum": plain_bf16})):
            for impl, m in models.items():
                reset_attention_counts()
                got = m.forward_feature(big, **big_kw)
                torch.cuda.synchronize()
                counts = attention_counts()
                big_ms[(impl, dn)] = cuda_ms(lambda: m.forward_feature(big, **big_kw), 5)
                if impl == "einsum":
                    continue
                check(counts == forward_only(n_layers), f"{impl} {dn} at T = {BIG_T}: launches {counts}")
                check(tuple(got.shape) == (BIG_BATCH, BIG_T - 1, 768) and bool(torch.isfinite(got).all()),
                      f"{impl} {dn} at T = {BIG_T}: shape {tuple(got.shape)} or values")
                if dn == "float32":
                    err = float((got - want_f32).abs().max())
                    print(f"  {impl} float32 vs einsum float32: max_abs {err:.3e} (atol {MODEL_F32_ATOL}); "
                          f"launches {counts}")
                    check(err <= MODEL_F32_ATOL, f"{impl} at T = {BIG_T} disagrees with einsum")
                else:
                    rel, rel_same = rel_l2(got.float(), want_f32), rel_l2(got.float(), want_bf16.float())
                    print(f"  {impl} bf16 vs einsum float32: rel_l2 {rel:.3e} (< {MODEL_BF16_REL_L2}); vs einsum bf16 "
                          f"{rel_same:.3e}; launches {counts}")
                    check(rel < MODEL_BF16_REL_L2, f"bf16 {impl} at T = {BIG_T} far from float32")
    print("  forward_feature B=16 at 448², CUDA events over 5 calls: " +
          ", ".join(f"{impl} {dn} {ms:.3f} ms" for (impl, dn), ms in big_ms.items()) + f" ({card})")
    del plain_model, plain_bf16, flash_model, flash_bf16, want_f32, want_bf16, got, big

    # phase 5: training in exact mode, bf16 compute over float32 params, the recipe's optimizer
    trng = np.random.default_rng(1)
    images = torch.from_numpy(trng.integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    targets = {
        t: torch.from_numpy(trng.standard_normal((TRAIN_BATCH, *get_model_feature_size(t, keep_spatial=True)),
                                                 dtype=np.float32)).to("cuda", torch.bfloat16)
        for t in teachers
    }
    lr = scaled_lr(BASE_LR, TRAIN_BATCH, 1, BASE_BATCH, BASE_WORLD)

    def reset_counts():
        reset_attention_counts()
        ln_pallas.LN_BWD_STATS_LAUNCHES = ln_pallas.LN_BWD_DX_LAUNCHES = 0
        fused_loss.LOSS_SUMS_FWD_LAUNCHES = fused_loss.LOSS_SUMS_BWD_LAUNCHES = fused_loss.LOSS_INPUT_COPIES = 0

    def read_counts():
        return {
            **attention_counts(),
            "ln_bwd_stats": ln_pallas.LN_BWD_STATS_LAUNCHES, "ln_bwd_dx": ln_pallas.LN_BWD_DX_LAUNCHES,
            "loss_sums_fwd": fused_loss.LOSS_SUMS_FWD_LAUNCHES, "loss_sums_bwd": fused_loss.LOSS_SUMS_BWD_LAUNCHES,
            "loss_input_copies": fused_loss.LOSS_INPUT_COPIES,
        }

    def trainer(dtype, impl, **flags):
        m = attention_model(impl, dtype=dtype, generator=torch.Generator().manual_seed(2), **flags)
        tx = make_optimizer(constant_with_warmup(lr, WARMUP_STEPS), weight_decay=0.01, betas=(0.9, 0.999),
                            eps=1e-8, moment_dtype=torch.bfloat16)
        return m, tx, TrainState.create(dict(m.named_parameters()), tx)

    def train(label: str, steps: int = TRAIN_STEPS, impl: str = "pallas", **flags) -> tuple[dict, int]:
        """``steps`` steps and one eval on the fixed batch through attention
        ``impl``, with the launch counts set to 0 just before and read just
        after; checks a finite, falling loss. Returns the counts and the
        number of LayerNormSpatial sites."""
        tmodel, tx, state = trainer(torch.bfloat16, impl, **flags)
        step = make_train_step(tmodel, tx, main_loss="cos_l1")
        eval_step = make_eval_step(tmodel, main_loss="cos_l1")
        n_ln = sum(isinstance(mod, layers.LayerNormSpatial) for mod in tmodel.modules())
        print(f"{label}: {MODEL}, float32 params, bf16 compute, bf16 Adam moments, lr {lr:g} (scaled_lr at batch "
              f"{TRAIN_BATCH}, world 1), warmup {WARMUP_STEPS}, cos_l1, {flags or 'exact mode'}, attention {impl}; "
              f"{tmodel.backbone.cfg.num_layers} attention layers, {n_ln} LayerNormSpatial sites")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        losses = []
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        for i in range(steps):
            if i == 5:
                start.record()
            state, metrics = step(state, images, targets)
            losses.append(metrics["loss"])
        end.record()
        eval_metrics = eval_step(images, targets)
        torch.cuda.synchronize()
        counts = read_counts()
        train_s = time.perf_counter() - t0
        step_ms = start.elapsed_time(end) / (steps - 5)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        losses = [float(x) for x in losses]
        eval_loss = float(eval_metrics["loss"])
        print(f"  {steps} steps + 1 eval in {train_s:.1f} s; losses {losses[0]:.6f} -> {losses[-1]:.6f}; "
              f"eval loss {eval_loss:.6f}")
        print(f"  losses: {' '.join(f'{x:.6f}' for x in losses)}")
        check(all(math.isfinite(x) for x in losses + [eval_loss]), f"{label}: a training loss is not finite")
        check(losses[-1] < losses[0], f"{label}: the training loss did not fall")
        print(f"  train step B={TRAIN_BATCH}: {step_ms:.3f} ms/step, {TRAIN_BATCH / step_ms * 1e3:.1f} images/s "
              f"(CUDA events over steps 6-{steps}), peak memory allocated {peak_gb:.2f} GB ({card})")
        del tmodel, tx, state, step, eval_step, metrics, eval_metrics
        torch.cuda.empty_cache()
        return counts, n_ln

    n_teachers, evals = len(teachers), 1

    def expected_launches(steps: int, attention_launches: dict) -> dict:
        """The launches of ``steps`` steps and one eval: the attention
        kernels' as given, K3/K4 at every LayerNormSpatial site of a step, K5
        for each teacher on every step and eval, K6 on every step."""
        return {**attention_launches, "ln_bwd_stats": n_ln * steps, "ln_bwd_dx": n_ln * steps,
                "loss_sums_fwd": n_teachers * (steps + evals), "loss_sums_bwd": n_teachers * steps,
                "loss_input_copies": 0}

    exact_counts, n_ln = train("phase 5, training (exact mode)")
    want = expected_launches(TRAIN_STEPS, {"mha_fwd": n_layers * (TRAIN_STEPS + evals),
                                           "mha_bwd": n_layers * TRAIN_STEPS, "flash_fwd": 0, "flash_dq": 0,
                                           "flash_dkv": 0})
    print(f"  launches {exact_counts}, expected {want}")
    check(exact_counts == want, "kernel launch counts of the exact-mode training path are off")

    # one step from identical weights: kernel path vs plain path, float32 and bf16
    def grads_on(path: str, dtype: torch.dtype, impl: str = "pallas", **flags):
        seed = torch.Generator().manual_seed(3)
        if path == "kernel":
            return loss_and_grads(attention_model(impl, dtype=dtype, generator=seed, **flags), images, targets)
        layers.LN_STATS_IMPL, loss_module.FUSED_LOSS = "vpu", False
        try:
            return loss_and_grads(attention_model("einsum", dtype=dtype, generator=seed, **flags), images, targets)
        finally:
            layers.LN_STATS_IMPL, loss_module.FUSED_LOSS = "pallas", True

    def kernel_vs_plain(loss_rtol: float, impl: str = "pallas", **flags):
        (kloss, kgrads), (ploss, pgrads) = (grads_on("kernel", torch.float32, impl, **flags),
                                            grads_on("plain", torch.float32, **flags))
        names = [n for n in pgrads if not n.endswith("key.bias")]
        worst = max((rel_l2(kgrads[n], pgrads[n]), n) for n in names)
        key_bias = max(float(g.abs().max()) for n, g in kgrads.items() if n.endswith("key.bias"))
        print(f"  one float32 step, kernel path (attention {impl}) vs plain path (attention einsum, LN_STATS_IMPL "
              f"vpu, FUSED_LOSS False): loss {kloss:.7f} vs {ploss:.7f} (rtol {loss_rtol}); worst gradient rel_l2 "
              f"{worst[0]:.3e} ({worst[1]}; < {TRAIN_GRAD_REL_L2}); key-bias gradients (0 in exact arithmetic) max "
              f"abs {key_bias:.2e}")
        check(abs(kloss - ploss) <= loss_rtol * abs(ploss), "training loss: kernel path vs plain path")
        check(worst[0] < TRAIN_GRAD_REL_L2, "a gradient: kernel path vs plain path")
        return names, kgrads

    names, kgrads = kernel_vs_plain(TRAIN_LOSS_RTOL)
    bf16_err = {}
    for path in ("kernel", "plain"):
        _, bgrads = grads_on(path, torch.bfloat16)
        parts = {"all": names, "backbone": [n for n in names if n.startswith("backbone.")],
                 **{t: [n for n in names if f".{t.replace('.', '_')}." in n] for t in teachers}}
        errs = {k: rel_l2(torch.cat([bgrads[n].flatten() for n in v]), torch.cat([kgrads[n].flatten() for n in v]))
                for k, v in parts.items()}
        bf16_err[path] = errs["all"]
        print(f"  bf16-compute ({path} path) vs float32 gradients, rel_l2: " +
              ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
        del bgrads
    print(f"  bf16 gradients: kernel path rel_l2 {bf16_err['kernel']:.3e} vs the plain path's {bf16_err['plain']:.3e} "
          f"(limit {TRAIN_BF16_GRAD_FACTOR} x the plain path's)")
    check(bf16_err["kernel"] <= TRAIN_BF16_GRAD_FACTOR * bf16_err["plain"],
          "bf16 gradients of the kernel path further from float32 than the plain path's")
    del kgrads
    torch.cuda.empty_cache()

    # the exact mode through attention_impl="flash": K7 forward, K9 and K8 backward
    flash_counts, _ = train("phase 5, training (exact mode, attention_impl=\"flash\")", FLASH_TRAIN_STEPS, "flash")
    want = expected_launches(FLASH_TRAIN_STEPS, {"mha_fwd": 0, "mha_bwd": 0,
                                                 "flash_fwd": n_layers * (FLASH_TRAIN_STEPS + evals),
                                                 "flash_dq": n_layers * FLASH_TRAIN_STEPS,
                                                 "flash_dkv": n_layers * FLASH_TRAIN_STEPS})
    print(f"  launches {flash_counts}, expected {want}")
    check(flash_counts == want, "kernel launch counts of the flash training path are off")
    _, fgrads = kernel_vs_plain(TRAIN_LOSS_RTOL, "flash")
    _, bgrads = grads_on("kernel", torch.bfloat16, "flash")
    flash_bf16_err = rel_l2(torch.cat([bgrads[n].flatten() for n in names]),
                            torch.cat([fgrads[n].flatten() for n in names]))
    print(f"  bf16 gradients through flash: rel_l2 {flash_bf16_err:.3e} from its float32 ones, vs the plain path's "
          f"{bf16_err['plain']:.3e} (limit {TRAIN_BF16_GRAD_FACTOR} x the plain path's)")
    check(flash_bf16_err <= TRAIN_BF16_GRAD_FACTOR * bf16_err["plain"],
          "bf16 gradients of the flash path further from float32 than the plain path's")
    del fgrads, bgrads
    torch.cuda.empty_cache()

    # one forward and backward of the backbone on 448² images through "pallas"
    # (the flash kernels at T = 785, 13 tiles of 64) against autograd through "einsum"
    bx = torch.from_numpy(trng.integers(0, 256, (BIG_TRAIN_BATCH, BIG_IMAGE, BIG_IMAGE, 3), dtype=np.uint8)).cuda()
    gtok = torch.randn(BIG_TRAIN_BATCH, BIG_T, 768, device="cuda",
                       generator=torch.Generator(device="cuda").manual_seed(5))

    def backbone_grads(impl: str):
        backbone = attention_model(impl, dtype=torch.float32, generator=torch.Generator().manual_seed(6)).backbone
        tokens = backbone(bx, **big_kw)
        params = dict(backbone.named_parameters())
        grads = torch.autograd.grad((tokens * gtok).sum(), list(params.values()))
        return tokens.detach(), dict(zip(params, grads))

    reset_attention_counts()
    tok, bgrads = backbone_grads("pallas")
    torch.cuda.synchronize()
    counts = attention_counts()
    want = {"mha_fwd": 0, "mha_bwd": 0, "flash_fwd": n_layers, "flash_dq": n_layers, "flash_dkv": n_layers}
    check(counts == want, f"the 448² backbone step launched {counts}, expected {want}")
    ptok, pgrads = backbone_grads("einsum")
    tok_err = float((tok - ptok).abs().max())
    bnames = [n for n in pgrads if not n.endswith("key.bias")]
    worst = max((rel_l2(bgrads[n], pgrads[n]), n) for n in bnames)
    print(f"  backbone forward and backward on [{BIG_TRAIN_BATCH},{BIG_IMAGE},{BIG_IMAGE},3], {big_kw} (T = {BIG_T}), "
          f"float32, \"pallas\" (launches {counts}) vs autograd through \"einsum\": tokens max_abs {tok_err:.3e} (atol "
          f"{MODEL_F32_ATOL}); worst gradient rel_l2 {worst[0]:.3e} ({worst[1]}; < {TRAIN_GRAD_REL_L2})")
    check(tok_err <= MODEL_F32_ATOL, "448² backbone tokens: flash kernels vs einsum")
    check(worst[0] < TRAIN_GRAD_REL_L2, "a 448² backbone gradient: flash kernels vs einsum")
    del tok, ptok, bgrads, pgrads, bx, gtok
    torch.cuda.empty_cache()

    # phase 6: the production recipe at full width and depth
    recipe = dict(fast_math=True, fuse_preprocessing=True)
    recipe_counts, _ = train("phase 6, training (the production recipe)", **recipe)
    want = expected_launches(TRAIN_STEPS, forward_only(0))
    print(f"  launches {recipe_counts}, expected {want}")
    check(recipe_counts == want, "kernel launch counts of the recipe's training path are off")
    kernel_vs_plain(RECIPE_LOSS_RTOL, **recipe)
    torch.cuda.empty_cache()
    with torch.inference_mode():
        fused_m = build_theia(MODEL, generator=torch.Generator().manual_seed(4), **recipe)
        unfused_m = build_theia(MODEL, fast_math=True, generator=torch.Generator().manual_seed(4))
        check(fused_m.backbone.fuse_preprocessing and not unfused_m.backbone.fuse_preprocessing, "fuse flags")
        a, b = fused_m.forward_feature(images), unfused_m.forward_feature(images)
        mse = float((a - b).square().mean())
        print(f"  forward_feature, fused preprocessing vs unfused (float32, fast_math, [{TRAIN_BATCH},196,768]): "
              f"mse {mse:.3e} (< {FUSED_PREPROCESSING_MSE}), rel_l2 {rel_l2(a, b):.3e}, tokens' mean square "
              f"{float(b.square().mean()):.3e}")
        check(bool(torch.isfinite(a).all()) and mse < FUSED_PREPROCESSING_MSE, "fused preprocessing far from unfused")
    del fused_m, unfused_m, a, b
    torch.cuda.empty_cache()

    # phase 6b: the training runtime, this slice's main path
    runtime_counts = training_runtime(card, teachers, reset_counts, read_counts,
                                      expected_launches(RUNTIME_STEPS, forward_only(0)))
    torch.cuda.empty_cache()

    # phase 7: timings
    print(f"phase 7: timings on {card}:")
    x1 = torch.from_numpy(requests[0]).cuda()
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
            ms = cuda_ms(lambda: m.forward_feature(x64), 20)
            if name == "bf16":
                # device time: 4 calls (~660 launches) stay within the launch queue while the stream is held
                held = statistics.mean(cuda_ms(lambda: m.forward_feature(x64), 4, hold=True) for _ in range(3))
                print(f"  forward_feature B=64 bf16 with the stream held: {held:.3f} ms/batch (CUDA events, "
                      f"3 x 4 calls); back to back: {ms:.3f} ms/batch (20 calls) ({card})")
            # the host's time to enqueue one call, the stream held by a sleep meanwhile
            enqueue = []
            for _ in range(5):
                torch.cuda.synchronize()
                torch.cuda._sleep(200_000_000)
                t0 = time.perf_counter()
                m.forward_feature(x64)
                enqueue.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            print(f"  forward_feature B=64 {name}: {ms:.3f} ms/batch, {64 / ms * 1e3:.1f} images/s (CUDA events, "
                  f"20 calls); host enqueue of one call p50 {statistics.median(enqueue):.3f} ms "
                  f"(min {min(enqueue):.3f}, max {max(enqueue):.3f}, 5 calls)")
    del model, model_bf16, ff, predict, ff_bf16
    torch.cuda.empty_cache()

    # each kernel at its main path's shape in bf16 (and float32 for the log):
    # kernel, plain version, one PyTorch call for the same function
    gen = torch.Generator(device="cuda").manual_seed(1)
    bf16 = torch.bfloat16
    record = {}

    def kernel_row(name, fns, nbytes, flops, dtype, shape):
        t = interleaved_ms(fns)
        bound, by = bound_ms(nbytes, flops, dtype)
        lib = t.get("library")
        print(f"  {name} {str(dtype).split('.')[-1]} {shape}: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, "
              f"library {'-' if lib is None else f'{lib:.4f} ms'}, bound {bound * 1e3:.1f} us ({by}: "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP)")
        return t, bound, by

    # the float32 records of the kernels whose float32 runs on the tensor
    # cores (K1 at [64, 197], K2 at [16, 197], K7, K9 and K8 at [16, 785])
    f32_records = {}

    def tf32_row(key: str, label: str, res, tc_flops: float, shape: str, err=None) -> None:
        """Print a float32 kernel's time against both bounds, the FMA peak's
        and the 3xTF32 tensor-core floor (three tf32 products for each
        float32 one); with ``err``, keep its float32 record."""
        (tm, bound, by), tc_bound = res, 3 * tc_flops / TF32_FLOPS * 1e3
        print(f"    {label} float32 {shape}: kernel / bound {tm['kernel'] / bound:.2f}x ({by}, FMA peak); "
              f"kernel / 3xTF32 tensor-core floor ({tc_bound * 1e3:.1f} us) {tm['kernel'] / tc_bound:.2f}x")
        if err is not None:
            f32_records[key] = {"ms": tm["kernel"], "plain_ms": tm["plain"], "library_ms": tm.get("library"),
                                "max_abs_err": err, "bound_ms": bound, "bound_by": by, "tf32x3_bound_ms": tc_bound}

    for dtype in (torch.float32, bf16):
        q, k, v = packed_qkv(64, 197, dtype, gen)
        n = q.numel()
        flops = 4 * 64 * 12 * 197 ** 2 * 64
        res = kernel_row("K1 mha_fwd", {
            "plain": lambda: attention.mha_fwd_plain(q, k, v), "kernel": lambda: attention.mha_fwd(q, k, v),
            "library": sdpa_forward(q, k, v)}, 4 * n * q.element_size(), flops, dtype, "[64,197,12,64]")
        if dtype == bf16:
            record["mha_fwd"] = res
        else:
            # float32 K1 runs its products as 3xTF32 on the tensor cores
            tf32_row("mha_fwd", "K1", res, flops, "[64,197,12,64]", kernel_errors[("mha_fwd", dtype, 64, 197)])
    for dtype in (torch.float32, bf16):
        q, k, v = packed_qkv(TRAIN_BATCH, 197, dtype, gen)
        do = torch.randn(TRAIN_BATCH, 197, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
        n = q.numel()
        flops = 10 * TRAIN_BATCH * 12 * 197 ** 2 * 64
        res = kernel_row("K2 mha_bwd", {
            "plain": lambda: attention.mha_bwd_plain(q, k, v, do), "kernel": lambda: attention.mha_bwd(q, k, v, do),
            "library": sdpa_backward(q, k, v, do)},
            7 * n * q.element_size(), flops, dtype, f"[{TRAIN_BATCH},197,12,64]")
        if dtype == bf16:
            record["mha_bwd"] = res
            print(f"    K2 bf16 [{TRAIN_BATCH},197,12,64]: kernel / bound {res[0]['kernel'] / res[1]:.2f}x ({res[2]})")
        else:
            tf32_row("mha_bwd", "K2", res, flops, f"[{TRAIN_BATCH},197,12,64]",
                     kernel_errors[("mha_bwd", dtype, TRAIN_BATCH, 197)])
    # K7 at serving's [64, 197] and 448² images' [16, 785]; K9 and K8 at
    # training's [16, 197] and [16, 785], each against its plain part, and
    # the pair against the plain backward and SDPA's backward
    # (``sdpa_backward``)
    for dtype in (torch.float32, bf16):
        for b, t in ((64, 197), (BIG_BATCH, BIG_T)):
            q, k, v = packed_qkv(b, t, dtype, gen)
            n, bh = q.numel(), b * HEADS
            flops = 4 * bh * t * t * HEAD_DIM
            res = kernel_row("K7 flash_fwd", {
                "plain": lambda: attention.flash_fwd_plain(q, k, v), "kernel": lambda: attention.flash_fwd(q, k, v),
                "library": sdpa_forward(q, k, v)}, 4 * n * q.element_size() + bh * t * 4, flops, dtype,
                f"[{b},{t},12,64]")
            if dtype == bf16:
                print(f"    K7 bf16 [{b},{t},12,64]: kernel / bound {res[0]['kernel'] / res[1]:.2f}x ({res[2]})")
                if t == BIG_T:
                    record["flash_fwd"] = res
            else:
                # float32 K7 runs its products as 3xTF32 on the tensor cores
                tf32_row("flash_fwd", "K7", res, flops, f"[{b},{t},12,64]",
                         kernel_errors[("flash_fwd", dtype, b, t)] if t == BIG_T else None)
        for t in (197, BIG_T):
            q, k, v = packed_qkv(TRAIN_BATCH, t, dtype, gen)
            do = torch.randn(TRAIN_BATCH, t, HEADS, HEAD_DIM, device="cuda", generator=gen).to(dtype)
            o, lse = attention.flash_fwd(q, k, v)
            _, di = attention.flash_dq(q, k, v, o, lse, do)
            n, bh, es = q.numel(), TRAIN_BATCH * HEADS, q.element_size()
            shape = f"[{TRAIN_BATCH},{t},12,64]"
            r9 = kernel_row("K9 flash_dq", {
                "plain": lambda: attention.flash_dq_plain(q, k, v, o, lse, do),
                "kernel": lambda: attention.flash_dq(q, k, v, o, lse, do)},
                6 * n * es + 2 * bh * t * 4, 6 * bh * t * t * HEAD_DIM, dtype, shape)
            r8 = kernel_row("K8 flash_dkv", {
                "plain": lambda: attention.flash_dkv_plain(q, k, v, lse, di, do),
                "kernel": lambda: attention.flash_dkv(q, k, v, lse, di, do)},
                6 * n * es + 2 * bh * t * 4, 8 * bh * t * t * HEAD_DIM, dtype, shape)
            pair = {"plain": lambda: attention.flash_bwd_plain(q, k, v, o, lse, do),
                    "kernel": lambda: attention.flash_bwd(q, k, v, o, lse, do), "library": sdpa_backward(q, k, v, do)}
            rp = kernel_row("K9 + K8 flash backward", pair, 8 * n * es + bh * t * 4, 14 * bh * t * t * HEAD_DIM, dtype,
                            shape)
            if dtype == bf16 and t == BIG_T:
                record["flash_dq"], record["flash_dkv"] = r9, r8
            elif dtype == torch.float32:
                # float32 K9 and K8 run their products as 3xTF32 on the tensor cores
                errs = {key: kernel_errors[(key, dtype, BIG_BATCH, BIG_T)] for key in ("flash_dq", "flash_dkv")}
                errs["pair"] = max(errs.values())
                for key, label, res, products in (("flash_dq", "K9", r9, 6), ("flash_dkv", "K8", r8, 8),
                                                  ("pair", "K9 + K8", rp, 14)):
                    flops = products * bh * t * t * HEAD_DIM
                    tf32_row(key, label, res, flops, shape, errs[key] if t == BIG_T else None)
    f32_records["flash_dkv"]["pair"] = f32_records.pop("pair")
    ln_rows = {}
    for dtype, s in [(bf16, 16), (bf16, 31), (bf16, 64), (torch.float32, 64)]:
        x, g, w, mean, r = ln_inputs(TRAIN_BATCH, 768, s, dtype, gen)
        s1, s2 = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)[:2]
        # one PyTorch call for the whole LayerNorm backward, on its own NCHW-contiguous copy
        xl, gl = x.contiguous(), g.contiguous()
        wl = w.to(dtype)
        _, lmean, lrstd = torch.native_layer_norm(xl, wl.shape, wl, torch.zeros_like(wl), 1e-5)
        library = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731
            gl, xl, list(wl.shape), lmean, lrstd, wl, torch.zeros_like(wl), [True, True, True])
        maps = x.numel() * x.element_size()
        per_sample = x[0].numel()
        shape = f"[{TRAIN_BATCH},768,{s},{s}]"
        r3 = kernel_row("K3 ln_bwd_stats", {
            "plain": lambda: ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g),
            "kernel": lambda: ln_pallas.ln_bwd_stats(x, w, mean, r, g), "library": library},
            2 * maps + per_sample * 4 * 3, 8 * x.numel(), dtype, shape)
        r4 = kernel_row("K4 ln_bwd_dx", {
            "plain": lambda: ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2),
            "kernel": lambda: ln_pallas.ln_bwd_dx(x, w, mean, r, g, s1, s2), "library": library},
            3 * maps + per_sample * 4, 8 * x.numel(), dtype, shape)
        if dtype == bf16 and s == 64:
            record["ln_bwd_stats"], record["ln_bwd_dx"] = r3, r4
        if dtype == bf16:
            ln_rows[s] = (r3, r4)
    # a recipe step's 15 LayerNormSpatial sites (bf16): 11 at 16x16, 2 at 31x31, 2 at 64x64
    for i, name in enumerate(("K3 ln_bwd_stats", "K4 ln_bwd_dx")):
        total = sum(n * ln_rows[s][i][0]["kernel"] for s, n in LN_SITES.items())
        bound = sum(n * ln_rows[s][i][1] for s, n in LN_SITES.items())
        print(f"    {name} bf16, a recipe step's 15 sites (11/2/2 at 16²/31²/64²): kernel {total:.4f} ms, bound "
              f"{bound:.4f} ms, bound / kernel {100 * bound / total:.1f}%")

    # K5 and K6 over the five teachers of one step: [16, D] bf16 pred from
    # the heads, float32 targets (the recipe's loss_dtype), and float32 both
    shapes = "+".join(f"[{TRAIN_BATCH},{d}]" for d in teacher_dims)
    for pdt in (bf16, torch.float32):
        preds = [torch.randn(TRAIN_BATCH, d, device="cuda", generator=gen).to(pdt) for d in teacher_dims]
        tgts = [torch.randn(TRAIN_BATCH, d, device="cuda", generator=gen) for d in teacher_dims]
        gs = [torch.randn(TRAIN_BATCH, 5, device="cuda", generator=gen) for _ in teacher_dims]
        n = TRAIN_BATCH * sum(teacher_dims)
        pb = preds[0].element_size()
        r5 = kernel_row("K5 loss_sums_fwd", {
            "plain": lambda: [fused_loss.loss_sums_plain(p, t) for p, t in zip(preds, tgts)],
            "kernel": lambda: [fused_loss.loss_sums_fwd(p, t) for p, t in zip(preds, tgts)]},
            n * (pb + 4) + len(teacher_dims) * TRAIN_BATCH * 5 * 4, 10 * n, torch.float32, f"{str(pdt).split('.')[-1]} pred, float32 target, {shapes}")
        r6 = kernel_row("K6 loss_sums_bwd", {
            "plain": lambda: [fused_loss.loss_sums_bwd_plain(p, t, g) for p, t, g in zip(preds, tgts, gs)],
            "kernel": lambda: [fused_loss.loss_sums_bwd(p, t, g) for p, t, g in zip(preds, tgts, gs)]},
            n * (2 * pb + 4) + len(teacher_dims) * TRAIN_BATCH * 5 * 4, 10 * n, torch.float32, f"{str(pdt).split('.')[-1]} pred, float32 target, {shapes}")
        if pdt == bf16:
            record["loss_sums_fwd"], record["loss_sums_bwd"] = r5, r6

    # the loss section of a step, forward and backward, fused against unfused
    hw_c = [(get_model_feature_size(t)[1], get_model_feature_size(t)[0]) for t in teachers]
    lpreds = {t: torch.randn(TRAIN_BATCH, hw, c, device="cuda", generator=gen).to(bf16).requires_grad_(True)
              for t, (hw, c) in zip(teachers, hw_c)}
    ltargets = {t: torch.randn(TRAIN_BATCH, hw, c, device="cuda", generator=gen) for t, (hw, c) in zip(teachers, hw_c)}

    def loss_section(fused):
        main = loss_module.main_loss_from_terms(loss_module.get_loss(lpreds, ltargets, fused=fused), "cos_l1")
        return torch.autograd.grad(main, list(lpreds.values()))

    sections = {"unfused": lambda: loss_section(False), "fused": lambda: loss_section(True)}
    # a section is ~200 launches: 2 calls stay within the launch queue while the stream is held
    dev, wall = interleaved_ms(sections, iters=2), interleaved_ms(sections, iters=5, hold=False)
    print(f"  loss section of a step, forward + backward (get_loss + main loss + d pred, five cddsv teachers, "
          f"bf16 pred, float32 targets): device time fused {dev['fused']:.4f} ms, unfused {dev['unfused']:.4f} ms; "
          f"back-to-back as the host issues them: fused {wall['fused']:.4f} ms, unfused {wall['unfused']:.4f} ms")

    meta = {
        "mha_fwd": ("csrc/mha_fwd.cu", "theia_tpu/ops/attention.py:46", kernel_errors[("mha_fwd", bf16, 64, 197)]),
        "mha_bwd": ("csrc/mha_bwd.cu", "theia_tpu/ops/attention.py:60", kernel_errors[("mha_bwd", bf16, 16, 197)]),
        "ln_bwd_stats": ("csrc/ln_bwd.cu", "theia_tpu/ops/ln_pallas.py:56", kernel_errors[("ln_bwd_stats", bf16, 64)]),
        "ln_bwd_dx": ("csrc/ln_bwd.cu", "theia_tpu/ops/ln_pallas.py:90", kernel_errors[("ln_bwd_dx", bf16, 64)]),
        "loss_sums_fwd": ("csrc/fused_loss.cu", "theia_tpu/ops/fused_loss.py:25",
                          kernel_errors[("loss_sums_fwd", TRAIN_BATCH, max(teacher_dims), bf16, torch.float32)]),
        "loss_sums_bwd": ("csrc/fused_loss.cu", "theia_tpu/ops/fused_loss.py:54",
                          kernel_errors[("loss_sums_bwd", TRAIN_BATCH, max(teacher_dims), bf16, torch.float32)]),
        # the Pallas kernels of JAX's TPU flash attention library, which
        # theia_tpu/ops/attention.py:151 (_flash_attention) calls
        **{name: ("csrc/flash_attn.cu", f"{FLASH_LIBRARY}:{line}", kernel_errors[(name, bf16, BIG_BATCH, BIG_T)])
           for name, line in (("flash_fwd", 331), ("flash_dkv", 796), ("flash_dq", 1146))},
    }
    rows = []
    for name, (src, replaces, err) in meta.items():
        t, bound, by = record[name]
        # launches on the path that runs the kernel: the training runtime
        # (train_from_config at the recipe), or for the attention kernels,
        # which the recipe skips, exact mode's (the flash kernels: exact
        # mode's through attention_impl="flash")
        launches = runtime_counts[name] or exact_counts[name] or flash_counts[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"theia_tpu_torch/{src}", "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": bound, "bound_by": by, "library_ms": t.get("library"),
            **({"float32": f32_records[name]} if name in f32_records else {}),
        })
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
