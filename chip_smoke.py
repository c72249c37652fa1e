#!/usr/bin/env python3
"""Drive the PyTorch port's Theia serving, training, extraction and decoding paths once on one CUDA GPU.

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
   cddsv teachers' [16, D] and over a sweep of B and D, and K3 and K4 at
   the CortexBench policy heads' LayerNormSpatial shapes, [32, 256, 7|3|1,
   ·] and [32, 60, 7|3, ·] (C = 60: the kernels' one-element path), bf16
   and float32, timed beside ``native_layer_norm_backward`` and the bound;
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
6c. worker-process loading: 6b's config with ``dataset.num_workers`` =
   min(4, cores - 1): the first 3 batches of the ordered shm and queue
   loaders bit-equal to the same splits merged round-robin in this
   process, 3 steps of ``train_from_config`` with workers (finite losses,
   exact launch counts, the loader's share of the wall), and
   ``measure_loader_throughput`` at 0, 1, 2, 4 and cores - 1 workers in
   both transports on 256 more samples, with the host's cores, /dev/shm's
   free bytes and the transport that ran;
4b. serving the student 6b trained: ``from_pretrained`` from the run's
   checkpoint directory, its step-6 file and a safetensors file of its
   state dict, each served through ``Predictor`` at B=16 in float32, bf16
   (K1) and through "flash" (K7), bit-equal to the same build with the
   weights copied in directly, moved from the random init, within MSE 5e-4
   of the trained model's recipe forward (float32), with K1's or K7's
   launches, the load time and the first request's latency;
4c. export: the float32 student's ``forward_feature`` exported, saved and
   loaded; the artifact's graph calls K1's operator and its outputs at
   B = 1, 3, 16 equal the eager model's within atol 1e-5; B=1 latency of
   phase 4's model, the student and the artifact;
8. the teachers and offline extraction (run after 4c): ViT-H, SAM-H,
   CLIP-L, DINOv2-L, Depth-Anything-L and LLaVA's tower at full width and
   depth on seeded random weights (built on the card), float32, on B=8
   uint8 224² images: the reference's stored keys and shapes, finite
   values, exact attention launches (ViT-H K7 = 32 a call at [8, 257, 16,
   80], the others none), images/s and peak memory (SAM-H also at the
   extraction's default batch of 32); ViT-H on its kernel path against
   "einsum" (float32, atol 1e-3) and in bf16 against float32 (rel L2
   5e-2); a DeiT teacher's K1 = 12 a call; K7 at [8, 257, 16, 80] against
   its plain version; then ``python -m
   theia_tpu_torch.scripts.feature_extraction``'s ``main`` for the five
   cddsv teachers over 2 synthetic image shards of 16 in a temporary
   directory (K7 = 64 in all), a rerun that skips every shard,
   ``compute_feature_stats`` and the training loader's first batch of the
   shards, and what ``check_shard`` returns (bit-exact regeneration at a
   batch of 3) with its max|d|;
9. the other translators (run after 4c, on phase 6b's shards): Theia-Base
   cddsv with the mlp, conv and transformer translators at the configs'
   widths (``configs/model/translator/``): each served at B=16 in float32
   and bf16 (shapes [16, H·W, C], finite, bf16 within rel L2 5e-2 of
   float32), trained 3 steps of ``train_from_config`` at the recipe
   (finite losses; exact launches: K5 = K6 = 5 a step, K3 = K4 = 15 a step
   for conv and 0 for the others), its saved step loaded by
   ``load_theia_checkpoint`` into a fresh model (every tensor equal to the
   file's, predictions bit-equal to the same weights copied in under
   cuDNN's deterministic algorithms); one exact-mode step of the conv
   translator (K1 = K2 = 12); K3 and K4 at the conv heads' [16, 1024, 16,
   16], [16, 2048, 16, 16], [16, 2048, 31, 31] and [16, 2048, 64, 64] in
   bf16 and float32 against their plain versions, timed beside
   ``native_layer_norm_backward`` and the bound; step ms, images/s and peak
   memory of each translator;
10. decoding: a Theia-Base cddsv student, the full ``SamDecoderConfig``
   mask decoder (seeded) and Depth-Anything-L's head tail, on B=2 uint8
   224² images, ``decode_everything(gt=True)`` through the full-width
   DINOv2-L, SAM-H and Depth-Anything-L (both rows [224, 896, 3], finite,
   in [0, 1] but where masks overlap); the card's mask decoder against the
   same decoder on the CPU (masks atol 1e-3, IoU 1e-4, float32); AMG at
   32² points at the defaults and with both thresholds at their minimum
   (masks through ``filter_masks``, ``box_nms`` and the RLE round trip);
   the time of each decoder and of ``decode_everything``;
11. data parallelism (run after 9, on phase 6b's shards): ``torchrun
   --nproc_per_node=1 -m theia_tpu_torch.scripts.train_rvfm`` at the recipe,
   batch 32 (3 steps and the save; one process makes no process group);
   the step's collectives on a one-rank NCCL group (the bf16 gradient
   bucket, the metrics' all-reduce, the barrier, the broadcast); two gloo
   ranks on this one card (NCCL refuses two ranks on one device;
   ``tools/two_rank_step.py``), 8 rows each, 3 recipe steps with the bf16
   wire and 3 with float32: the ranks' parameters and Adam moments
   bit-equal, exact launch counts a rank, losses within rtol 2e-2 of one
   process on the whole batch, each rank's step and all-reduce times
   (CUDA events), and in exact mode the all-reduced gradient against one
   process's (the mean of its two half-batch passes within rel L2 1e-5 on
   the float32 wire and 2^-8 on bf16; its one whole-batch pass within 5e-3);
12. the downstream modules (run after 10): ``load_model`` on phase 4's
   model ((768, 14, 14), B=1 p50), ``ConvBatchNormMLP`` and
   ``ConvPolicyHead`` over 3 frames of its features at B=32, forward and
   backward through K3/K4 (3 + 3 and 2 + 2 launches) against the plain
   backward (float32, atol 1e-3), a ``VFMEncoder`` over DINOv2-L and a
   ``ConcatVFMEncoder`` over DINOv2-L and CLIP-L at B=8 (seeded weights);
13. tensor parallelism (run after 12): K4 against its plain version with
   the normaliser's count twice the row length (a sample whose channels two
   ranks split) at the lconv ladder's [16, 384, 31|64, ·] and the conv
   translator's [16, 1024, 31|16, ·] in bf16 and float32, K3/K4 timed
   there; one pair of gloo ranks at ``model_axis=2`` on this card
   (``tools/tp_step.py``), both on one global batch of 16, runs the lconv,
   conv, mlp and transformer translators in turn, 2 recipe steps each: the
   losses and the gathered parameters' change against one process's on
   the same batch, the replicated parameters bit-equal on both ranks (and
   the replicated gradients before their bucket), exact launch counts a
   rank, the audit's model-group all-reduces against the plan's (2 a block
   each way, a head's row-parallel outputs, split LayerNorm sums and loss
   sums forward, its column-parallel inputs and split LayerNorm sums back,
   and the replicated bucket), each rank's step ms, the all-reduces' share
   and its peak memory against one process's; for lconv and conv one
   exact-mode step, its launches and its gathered gradient against one
   process's (rel L2 5e-3);
7. timings with CUDA events after warmup (bf16 ``forward_feature`` at B=64
   also with the stream held, the device's time alone), and each kernel's
   bound and library call; K3's and K4's sums over a recipe step's 15
   LayerNormSpatial sites against their bounds.

Each phase ends with a line ``[phase N done at T s]``, the script's elapsed
host time. The last two lines of standard output are the kernels' JSON record (the
bf16 figures; ``mha_fwd``, ``mha_bwd``, ``flash_fwd``, ``flash_dq`` and
``flash_dkv`` also carry their float32 ones under ``"float32"``, with the 3xTF32
tensor-core floor, and ``flash_dkv``'s the pair K9 + K8's under ``"pair"``;
``flash_fwd_vit_h`` is K7 at phase 8's [8, 257, 16, 80] in float32, with
its bf16 figures under ``"bfloat16"``; ``ln_bwd_stats`` and ``ln_bwd_dx``
carry phase 9's conv-translator shapes under ``"conv_translator"`` and
phase 3's policy-head shapes under ``"policy_heads"``)
and ``{"ok": true, "device": {...}}``. Without a CUDA device, or run from a
directory without the package beside it, the script exits nonzero.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# 8 samples a shard: 12 train shards, so that every loader worker of phase 6c
# reads a disjoint subset of at least one
RUNTIME_SHARD = 8
# phase 6c: worker-process loading. The loop trains 3 steps with workers;
# the loader's throughput is measured on its own shards (16 of 16 samples),
# 2 batches of warmup (the workers' start) and 12 timed
LOADER_STEPS, LOADER_COMPARE_BATCHES = 3, 3
LOADER_TRAIN, LOADER_SHARD, LOADER_WARMUP, LOADER_BATCHES = 256, 16, 2, 12
# phase 4c: the exported forward_feature against the eager model in float32
# (the same kernels and float32 ops; the batch is symbolic in the graph)
EXPORT_F32_ATOL = 1e-5
EXPORT_BATCHES = (1, 3, 16)
RUNTIME_OVERRIDES = ("model/backbone=deit_base", "training/target_models=cddsv", "dataset.dataset_ratio=1.0",
                     f"training.batch_size={TRAIN_BATCH}", "logging.save_ckpt_interval=3",
                     "logging.log_interval=2")
# phase 8: the teachers at full width and depth, float32, on B uint8 224²
# images (the ImageNet shards' size); SAM-H also at the extraction's default
# batch; feature_extraction.main over 2 synthetic image shards of 16
TEACHER_BATCH, EXTRACTION_BATCH = 8, 32
EXTRACT_SHARDS, EXTRACT_SHARD_SIZE = 2, 16
VIT_H = "google/vit-huge-patch14-224-in21k"
DEIT_TEACHER = "facebook/deit-base-patch16-224"
# phase 9: the other translators at the configs' widths (configs/model/translator/),
# served at B=16 and trained TRANSLATOR_STEPS steps of train_from_config on
# phase 6b's shards; the conv translator's new LayerNormSpatial shapes
# (C, side) under K3/K4 at the batch of 16
TRANSLATORS = ("mlp", "conv", "transformer")
TRANSLATOR_STEPS = 3
CONV_LN_SHAPES = ((1024, 16), (2048, 16), (2048, 31), (2048, 64))
# phase 10: decoding on B uint8 224² images; the card's mask decoder against
# the same decoder on the CPU (float32, TF32 off), at AMG's point batch
DECODE_BATCH, AMG_POINTS_PER_SIDE = 2, 32
DECODER_MASK_ATOL, DECODER_IOU_ATOL = 1e-3, 1e-4
# phase 3: K3/K4 at the CortexBench policy heads' LayerNormSpatial shapes
# (utils/cortexbench/policy_heads.py): ConvBatchNormMLP's 256 channels at
# 7², 3² and 1², ConvPolicyHead's 60 (not a multiple of 8) at 7² and 3²,
# at a batch of 32
POLICY_LN_SHAPES = ((256, 7), (256, 3), (256, 1), (60, 7), (60, 3))
POLICY_BATCH = 32
# phase 11: data parallelism. (a) the CLI under torchrun at one process on
# phase 6b's shards, batch 32: 3 steps and the save; (b) two gloo ranks on
# the card, DP_ROWS rows each, DP_STEPS recipe steps a wire dtype, against
# one process on the whole batch: losses (bf16 compute) within rtol 2e-2;
# in exact mode, the all-reduced gradient bit-equal to the wire dtype's sum
# of the ranks' local gradients each halved and cast, and within
# TRAIN_GRAD_REL_L2 of one process's gradient on the whole batch (the
# float32 forward is not bitwise repeatable on the card, and the heads'
# ReLUs flip where a pre-activation is within rounding of 0)
DP_CLI_BATCH, DP_ROWS, DP_STEPS = 32, 8, 3
DP_LOSS_RTOL = 2e-2
# phase 12: the policy heads at B = 32 over Theia-Base's (768, 14, 14)
# features, 3 frames and 9 proprioceptive values, 7 actions; kernel path
# against the plain backward (LN_STATS_IMPL="vpu"), float32; the VFM
# encoders at B = 8
HEAD_BATCH, HEAD_HISTORY, HEAD_PROPRIO, HEAD_ACTIONS = 32, 3, 9, 7
HEAD_F32_ATOL = 1e-3
VFM_BATCH = 8
# phase 13: tensor parallelism. K4 with the normaliser's count twice the
# row length (a sample whose channels two ranks split) at the split
# ladders' LayerNormSpatial shapes (lconv's 768 channels, the conv
# translator's 2048, halved); two gloo ranks at model_axis=2 on the card,
# both on the same global batch, TP_STEPS recipe steps of each of
# TP_TRANSLATORS against one process's: losses within DP_LOSS_RTOL, the
# parameters' change within TP_CHANGE_REL_L2 of one process's change
# (relative L2: Adam's first steps move each parameter by about the
# learning rate whatever the gradient's size, so bf16 rounding that flips
# the sign of a small gradient moves that parameter by twice the step),
# the exact-mode gradient of tools/tp_step.EXACT_TRANSLATORS' within
# TRAIN_GRAD_REL_L2
TP_ROWS, TP_STEPS = 16, 2
TP_LN_SHAPES = ((384, 31), (384, 64), (1024, 31), (1024, 16))
TP_CHANGE_REL_L2 = 0.5
TP_TRANSLATORS = ("lconv", "conv", "mlp", "transformer")
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


def runtime_config(tmp: str, epochs: int = 1, extra: tuple = ()):
    """Phase 6b's config: the recipe, Theia-Base cddsv, batch 16, on the shards under ``tmp``."""
    from theia_tpu_torch.config import load_config

    return load_config("train_rvfm_imagenet", [
        *RUNTIME_OVERRIDES, f"dataset.dataset_root={tmp}", f"training.epochs={epochs}",
        f"logging.model_path={tmp}/ckpt", f"logging.log_path={tmp}/logs", *extra])


def run_quietly(fn, reset_counts, read_counts) -> tuple[dict, dict, list[str]]:
    """``fn()`` (a ``train_from_config`` call) with the launch counts set to 0
    just before and read just after; its own printing is kept apart."""
    import contextlib
    import io

    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out):
        summary = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    return summary, counts, [ln for ln in out.getvalue().splitlines() if ln.startswith("[theia_tpu_torch]")]


def sample_bytes_of(sizes: dict) -> int:
    """One synthetic sample: a 224² uint8 image and each teacher's bf16 features."""
    return 224 * 224 * 3 + sum(2 * math.prod(s) for s in sizes.values())


def training_runtime(card: str, tmp: str, teachers: list[str], reset_counts, read_counts,
                     expected: dict) -> tuple[dict, dict]:
    """Phase 6b: ``train.loop.train_from_config`` at the production recipe on
    synthetic shards written under ``tmp`` (left there for phases 6c and
    4b), a restore checked tensor for tensor against the file, and a
    resume. Returns the launch counts of the first call and the summary of
    the second."""
    import os
    import shutil

    from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES
    from theia_tpu_torch.train import loop
    from theia_tpu_torch.train.checkpoint import restore_checkpoint
    from theia_tpu_torch.train.state import TrainState

    sizes = {t: MODEL_FEATURE_SIZES[t] for t in teachers}
    sample_bytes = sample_bytes_of(sizes)
    cfg = runtime_config(tmp, 1)
    # the student at step 0, as the loop builds it; the restore below lands in it
    model = loop.build_model(cfg, "cuda")
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = TrainState.create(dict(model.named_parameters()), loop.build_optimizer(cfg, 0.0))
    ckpt_bytes = sum(t.numel() * t.element_size() for tree in (state.params, state.opt_state.mu,
                                                                state.opt_state.nu) for t in tree.values())
    need = sample_bytes * (RUNTIME_TRAIN + RUNTIME_VAL + LOADER_TRAIN) + 7 * ckpt_bytes + (1 << 30)
    free = shutil.disk_usage(tmp).free
    print(f"phase 6b, the training runtime: {MODEL} at the recipe through train_from_config; {tmp}: "
          f"{free / 1e9:.1f} GB free, {need / 1e9:.1f} GB needed ({RUNTIME_TRAIN + RUNTIME_VAL} samples of "
          f"{sample_bytes / 1e6:.2f} MB, phase 6c's {LOADER_TRAIN} more, 7 checkpoints of {ckpt_bytes / 1e9:.2f} "
          "GB, 1 GiB spare)")
    check(free >= need, f"{tmp} has {free} bytes free, the phase needs {need}")
    t0 = time.perf_counter()
    generate_synthetic_dataset(tmp, feature_models=sizes, n_train=RUNTIME_TRAIN, n_val=RUNTIME_VAL,
                               samples_per_shard=RUNTIME_SHARD, seed=0)
    print(f"  synthetic cddsv shards (224² uint8 images, bf16 features at the teachers' sizes, "
          f"{RUNTIME_SHARD} samples a shard): {time.perf_counter() - t0:.1f} s")

    def train(cfg) -> tuple[dict, dict, list[str]]:
        return run_quietly(lambda: loop.train_from_config(cfg), reset_counts, read_counts)

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

    summary2, counts2, lines2 = train(runtime_config(tmp, 2))
    for ln in lines2:
        print(f"  call 2: {ln}")
    report("call 2 (epochs=2, resumed)", summary2, counts2)
    check(any(f"resuming at step {RUNTIME_STEPS} " in ln for ln in lines2), "call 2 did not resume at step 6")
    check(summary2["step"] == 2 * RUNTIME_STEPS, f"call 2 ended at step {summary2['step']}")
    print(f"  call 2: the loop's own restore {summary2['timing']['restore_s']:.3f} s ({card})")
    return counts, summary2


class RoundRobin:
    """The ordered worker merge's order, iterated in this process: one sample
    from each part in turn, a part dropping out when it ends."""

    def __init__(self, parts: list) -> None:
        self.parts = parts

    def __iter__(self):
        iters = [iter(p) for p in self.parts]
        while iters:
            live = []
            for it in iters:
                for sample in itertools.islice(it, 1):
                    yield sample
                    live.append(it)
            iters = live


def leaves_equal(a, b) -> bool:
    if isinstance(a, dict):
        return set(a) == set(b) and all(leaves_equal(a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def latency_b1(fn, x1: torch.Tensor, calls: int = 50) -> tuple[float, float, float]:
    """p50, min and max ms of ``fn(x1)`` after 5 warmup calls: CUDA events
    around each synchronous call, so the host's launches are included."""
    with torch.inference_mode():
        for _ in range(5):
            fn(x1)
        samples = []
        for _ in range(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn(x1)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
    return statistics.median(samples), min(samples), max(samples)


def worker_loading(card: str, tmp: str, reset_counts, read_counts, expected: dict) -> None:
    """Phase 6c: phase 6b's config with ``dataset.num_workers``: the worker
    loader's first batches against the same splits merged in this process
    and against the queue transport, 3 steps of ``train_from_config`` with
    workers, and the loader's throughput at several worker counts."""
    import gc
    import os

    from theia_tpu_torch.data.dataset import get_frame_dataloader, get_image_video_dataset
    from theia_tpu_torch.data.parallel_loader import ParallelSampleSource, _shm_free_bytes, measure_loader_throughput
    from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES
    from theia_tpu_torch.train import loop

    cores = os.cpu_count() or 1
    workers = max(1, min(4, cores - 1))
    shm_free = _shm_free_bytes()
    print(f"phase 6c, worker-process loading: {cores} cores, /dev/shm {shm_free} bytes free; {workers} workers "
          f"on phase 6b's {RUNTIME_TRAIN // RUNTIME_SHARD} train shards ({card})")
    cfg = runtime_config(tmp, 1, (f"dataset.num_workers={workers}", f"logging.model_path={tmp}/ckpt_workers",
                                  f"logging.log_path={tmp}/logs_workers"))
    _, names, _ = loop.select_target_models(cfg)
    mix = cfg.dataset.dataset_mix
    ds_kwargs = dict(feature_models=names, dataset_mix=mix if isinstance(mix, str) else list(mix), split="train",
                     dataset_ratio=1.0, feature_norm=cfg.dataset.feature_norm, seed=cfg.seed)
    train_ds, _ = get_image_video_dataset(dataset_root=tmp, shuffle=cfg.dataset.shuffle, **ds_kwargs)

    def first_batches(source) -> list:
        loader = get_frame_dataloader(source, batch_size=TRAIN_BATCH, shuffle=cfg.dataset.shuffle,
                                      shuffle_buffer_size=cfg.dataset.shuffle_buffer_size, seed=cfg.seed)
        it = iter(loader)
        out = [next(it) for _ in range(LOADER_COMPARE_BATCHES)]
        it.close()
        return out

    t0 = time.perf_counter()
    shm_source = ParallelSampleSource(train_ds, workers, transport="shm")
    got = first_batches(shm_source)
    queue_source = ParallelSampleSource(train_ds, workers, transport="queue")
    queued = first_batches(queue_source)
    inproc = first_batches(RoundRobin(train_ds.split(workers)))
    equal = [leaves_equal(a, b) and leaves_equal(a, c) for a, b, c in zip(got, queued, inproc)]
    print(f"  first {LOADER_COMPARE_BATCHES} batches of {TRAIN_BATCH}, ordered, {workers} workers: transport "
          f"{shm_source.transport_used} (asked shm) and {queue_source.transport_used} (asked queue), bit-equal to each "
          f"other and to the same {workers} splits merged round-robin in this process: {equal} "
          f"({time.perf_counter() - t0:.1f} s)")
    check(all(equal) and len(equal) == LOADER_COMPARE_BATCHES, "worker batches differ from the in-process merge")
    del got, queued, inproc

    summary, counts, _ = run_quietly(
        lambda: loop.train_from_config(cfg, resume=False, max_steps=LOADER_STEPS), reset_counts, read_counts)
    t = summary["timing"]
    ev = summary["eval"]
    print(f"  train_from_config, {LOADER_STEPS} steps with dataset.num_workers={workers}: step {summary['step']}; "
          f"train loss {summary['train']['loss']:.6f}, eval cos {ev['avg_eval_cos_loss']:.6f}; launches {counts}, "
          f"expected {expected}")
    print(f"  loop wall {t['wall_s']:.3f} s for {t['steps']} steps + 1 eval + 1 save; waiting in the loaders' next() "
          f"{t['loader_wait_s']:.3f} s, {100 * t['loader_wait_s'] / t['wall_s']:.1f}% of the wall; the loop's "
          f"loader ran the {shm_source.transport_used} transport as above ({card})")
    check(summary["step"] == LOADER_STEPS and math.isfinite(summary["train"]["loss"])
          and all(math.isfinite(v) for v in ev.values()), "training with workers: a loss is not finite")
    check(counts == expected, "training with workers: kernel launch counts are off")

    root = os.path.join(tmp, "loader")
    sizes = {t: MODEL_FEATURE_SIZES[t] for t in names}
    t0 = time.perf_counter()
    generate_synthetic_dataset(root, feature_models=sizes, n_train=LOADER_TRAIN, n_val=1,
                               samples_per_shard=LOADER_SHARD, seed=1)
    print(f"  loader throughput shards: {LOADER_TRAIN} samples, {LOADER_TRAIN // LOADER_SHARD} shards "
          f"({time.perf_counter() - t0:.1f} s); batches of {TRAIN_BATCH} into pinned memory, {LOADER_WARMUP} "
          f"warmup (the workers' start), {LOADER_BATCHES} timed:")
    loader_ds, _ = get_image_video_dataset(dataset_root=root, shuffle=False, **ds_kwargs)
    for n in sorted({0, 1, 2, 4, cores - 1}):
        for transport in (("in-process",) if n == 0 else ("shm", "queue")):
            source = loader_ds if n == 0 else ParallelSampleSource(loader_ds, n, transport=transport)
            loader = get_frame_dataloader(source, batch_size=TRAIN_BATCH, pin_memory=True)
            r = measure_loader_throughput(loader, max_batches=LOADER_BATCHES, warmup=LOADER_WARMUP)
            ran = transport if n == 0 else source.transport_used
            print(f"    {n} workers, {transport} (ran {ran}): {r['images_per_sec']:.1f} images/s, "
                  f"{r['mb_per_sec']:.1f} MB/s ({r['batches']} batches in {r['seconds']:.3f} s)")
            check(r["batches"] == LOADER_BATCHES, "the loader ended early")
            del loader, source
            gc.collect()


def serve_trained(card: str, tmp: str, ckpt_dir: str, attention_model, reset_attention_counts, attention_counts,
                  forward_only) -> torch.nn.Module:
    """Phase 4b: phase 6b's student loaded by ``from_pretrained`` from its
    checkpoint directory, its step-6 file and a safetensors file of its
    state dict, each served through ``Predictor`` in float32, bf16 and
    through "flash", bit for bit against the same build with the weights
    copied in directly. Returns the float32 student loaded from the
    directory."""
    import os

    from theia_tpu_torch.data.webdataset import save_safetensors
    from theia_tpu_torch.models.hub import build_theia, from_pretrained
    from theia_tpu_torch.serving import Predictor
    from theia_tpu_torch.train import loop
    from theia_tpu_torch.train.checkpoint import all_steps

    steps = all_steps(ckpt_dir)
    newest, step6 = os.path.join(ckpt_dir, f"{steps[-1]}.pt"), os.path.join(ckpt_dir, f"{RUNTIME_STEPS}.pt")
    final = torch.load(newest, map_location="cpu", weights_only=True)["params"]
    at6 = torch.load(step6, map_location="cpu", weights_only=True)["params"]
    # the trained student as the loop builds it (the recipe's fast_math and
    # fused preprocessing), in float32 compute
    trained = loop.build_model(runtime_config(tmp, 2, ("training.compute_dtype=float32",)), "cuda").eval()
    trained.load_state_dict(final)
    st_path = os.path.join(tmp, "student.safetensors")
    t0 = time.perf_counter()
    with open(st_path, "wb") as f:
        f.write(save_safetensors(trained.state_dict()))
    print(f"phase 4b, serving a trained student: {MODEL} from phase 6b's run (committed steps {steps}); "
          f"safetensors of the trained model's state dict written in {time.perf_counter() - t0:.3f} s "
          f"({os.path.getsize(st_path) / 1e9:.2f} GB)")
    sources = {"checkpoint directory": (ckpt_dir, final), f"step-{RUNTIME_STEPS} .pt file": (step6, at6),
               "safetensors": (st_path, final)}
    variants = {"float32": ("pallas", dict(dtype=torch.float32)),
                "bf16": ("pallas", dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16)),
                "flash bf16": ("flash", dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16))}
    x16 = np.random.default_rng(5).integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8)
    n_layers = trained.backbone.cfg.num_layers
    with torch.inference_mode():
        trained_feats = trained.forward_feature(torch.from_numpy(x16).cuda()).float().cpu().numpy()
    del trained
    loaded = None
    for vname, (impl, kw) in variants.items():
        # the same build as from_pretrained's, weights copied in directly
        ref = attention_model(impl, generator=torch.Generator().manual_seed(0), **kw)
        ref_serve = Predictor(ref, buckets=BUCKETS)
        random_out = ref_serve(x16)
        want = {}
        for params in (final, at6):
            ref.load_state_dict(params)
            want[id(params)] = ref_serve(x16)
        del ref, ref_serve
        for sname, (path, params) in sources.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model = attention_model(impl, build=lambda name, **k: from_pretrained(name, checkpoint_path=path, **k),
                                    **kw)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            serve = Predictor(model, buckets=BUCKETS)
            reset_attention_counts()
            t0 = time.perf_counter()
            out = serve(x16)
            first_s = time.perf_counter() - t0
            counts = attention_counts()
            expect = forward_only(n_layers) if impl == "flash" else {**forward_only(0), "mha_fwd": n_layers}
            same = np.array_equal(out, want[id(params)])
            moved = float(np.abs(out - random_out).max())
            line = (f"  {sname}, {vname}: from_pretrained {load_s:.3f} s, first request (B={TRAIN_BATCH}) "
                    f"{first_s * 1e3:.1f} ms; bit-equal to the directly copied weights: {same}; max abs from the "
                    f"random init {moved:.3e}; launches {counts}")
            if vname == "float32" and params is final:
                mse = float(np.square(out - trained_feats).mean())
                line += f"; MSE against the trained model's recipe forward {mse:.3e} (< {FUSED_PREPROCESSING_MSE})"
                check(mse < FUSED_PREPROCESSING_MSE, f"{sname}: far from the trained model's forward")
            print(line + f" ({card})")
            check(out.shape == trained_feats.shape and bool(np.isfinite(out).all()), f"{sname} {vname}: output")
            check(same, f"{sname} {vname}: differs from the same weights copied in directly")
            check(moved > 1e-3, f"{sname} {vname}: equal to the random init")
            check(counts == expect, f"{sname} {vname}: launch counts are off (expected {expect})")
            if vname == "float32" and sname == "checkpoint directory":
                loaded = model
            del model, serve
        torch.cuda.empty_cache()
    return loaded


def export_trained(card: str, tmp: str, loaded, served, reset_attention_counts, attention_counts,
                   forward_only) -> None:
    """Phase 4c: the loaded student's forward_feature exported on the card,
    saved, loaded and run at several batch sizes against the eager model;
    B=1 latency of the eager path beside phase 4's model and the artifact."""
    import os

    from theia_tpu_torch import export

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob = export.export_model(loaded)
    export_s = time.perf_counter() - t0
    path = os.path.join(tmp, "student.pt2")
    with open(path, "wb") as f:
        f.write(blob)
    t0 = time.perf_counter()
    pred = export.load_artifact(path)
    load_s = time.perf_counter() - t0
    ops = sorted({str(n.target) for n in pred.program.graph.nodes if str(n.target).startswith("theia.")})
    print(f"phase 4c, export: forward_feature of the loaded student exported in {export_s:.1f} s, "
          f"{len(blob) / 1e9:.2f} GB, loaded in {load_s:.1f} s; header {pred.meta}; the graph's theia operators {ops}")
    check(ops == ["theia.mha_attention.default"], "the exported graph does not call K1's operator")
    n_layers = loaded.model.backbone.cfg.num_layers
    rng = np.random.default_rng(6)
    for n in EXPORT_BATCHES:
        x = rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)
        reset_attention_counts()
        got = pred(x)
        counts = attention_counts()
        with torch.inference_mode():
            want = loaded.forward_feature(torch.from_numpy(x).cuda()).cpu().numpy()
        err = float(np.abs(got - want).max())
        print(f"  B={n}: artifact vs eager max_abs {err:.3e} (atol {EXPORT_F32_ATOL}); the artifact's launches {counts}")
        check(got.shape == want.shape == (n, 196, loaded.model.backbone.cfg.hidden_size) and err <= EXPORT_F32_ATOL,
              f"the artifact at B={n} disagrees with eager")
        check(counts == {**forward_only(0), "mha_fwd": n_layers}, f"the artifact at B={n}: launch counts are off")
    x1 = torch.from_numpy(rng.integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)).cuda()
    timings = {"phase 4's model (eager)": latency_b1(served.forward_feature, x1),
               "the loaded student (eager)": latency_b1(loaded.forward_feature, x1),
               "the artifact": latency_b1(pred.module, x1),
               "phase 4's model again (eager)": latency_b1(served.forward_feature, x1)}
    print("  forward_feature B=1 float32 latency, CUDA events around each synchronous call (50 calls): " +
          "; ".join(f"{k} p50 {p:.3f} ms (min {lo:.3f}, max {hi:.3f})" for k, (p, lo, hi) in timings.items()) +
          f" ({card})")


def reference_layout(name: str) -> dict:
    """The reference's stored layout of one teacher's sample
    (feature_extraction_core/models.py:55-97): {store name: {key: shape}}."""
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES

    c, h, w = MODEL_FEATURE_SIZES[name]
    legit = name.replace("/", "_")
    if "google/vit" in name:
        return {legit: {"cls_token": (c,), "embedding": (c, h, w)}}
    if "facebook/sam" in name:
        return {legit: {"embedding": (c, h, w)}, legit + "_32": {"embedding": (c, 32, 32)}}
    if "openai/clip" in name or "facebook/dinov2" in name:
        return {legit: {"embedding": (c, h, w), "cls_token": (1, c), "pooled_cls_token": (1, c)}}
    return {legit: {"embedding": (c, h, w)}}


def teachers_and_extraction(card: str, tmp: str, teachers: list[str], attention, reset_attention_counts,
                            attention_counts, forward_only) -> dict:
    """Phase 8: every teacher at full width and depth on seeded random
    weights, float32 (TF32 off), at B = TEACHER_BATCH uint8 224² images: the
    reference's key layout and shapes, finite values, the attention kernels'
    exact launches (ViT-H K7 32 a call, a DeiT teacher K1 12), ViT-H on its
    kernel path against "einsum" and in bf16 against float32, images/s and
    peak memory (SAM also at the extraction's default batch); K7 at ViT-H's
    [8, 257, 16, 80] against its plain version; then
    ``feature_extraction.main`` for the cddsv teachers over synthetic image
    shards under ``tmp``, its resume skip, the shards read back by the
    training loader after ``compute_feature_stats``, and what ``check_shard``
    returns. Returns the main path's launch counts and K7's errors."""
    import contextlib
    import io
    import os

    from theia_tpu_torch.data.dataset import get_frame_dataloader, get_image_video_dataset
    from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
    from theia_tpu_torch.foundation import vit as fvit
    from theia_tpu_torch.foundation.common import MODELS, get_model_feature_size
    from theia_tpu_torch.foundation.extraction import get_feature_outputs, get_model
    from theia_tpu_torch.foundation.sam import SCORE_BLOCK_BYTES
    from theia_tpu_torch.scripts import calc_feature_mean, check_feature, feature_extraction
    from theia_tpu_torch.tools.timing import cuda_ms

    device = "cuda"
    print(f"phase 8, the teachers and offline extraction: {len(MODELS)} teachers at full width and depth, seeded "
          f"random weights, float32 (TF32 off), B={TEACHER_BATCH} uint8 224² images ({card})")
    rng = np.random.default_rng(8)
    images = torch.from_numpy(rng.integers(0, 256, (EXTRACTION_BATCH, 224, 224, 3), dtype=np.uint8)).to(device)
    x = images[:TEACHER_BATCH]
    for name in MODELS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        module, feature_fn = get_model(name, device=device, generator=torch.Generator(device).manual_seed(0))
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        n_params = sum(p.numel() for p in module.parameters())
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_attention_counts()
        feats = get_feature_outputs(name, module, x, feature_fn)
        counts = attention_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check(counts == forward_only(32 if name == VIT_H else 0), f"{name}: attention launches {counts}")
        for store, keys in reference_layout(name).items():
            check(sorted(feats.get(store, {})) == sorted(keys), f"{name}: {store} holds {sorted(feats.get(store, {}))}")
            for key, shape in keys.items():
                got = feats[store][key]
                check(tuple(got.shape) == (TEACHER_BATCH, *shape) and got.dtype == torch.bfloat16
                      and bool(torch.isfinite(got.float()).all()), f"{name}: {store}.{key} {tuple(got.shape)}")
        with torch.inference_mode():
            ms = cuda_ms(lambda: feature_fn(module, x), 3)
        line = (f"  {name}: {n_params / 1e6:.1f}M params built on the card in {build_s:.2f} s; "
                f"{TEACHER_BATCH / ms * 1e3:.1f} images/s ({ms:.1f} ms a batch of {TEACHER_BATCH}, CUDA events, "
                f"3 calls), peak {peak / 2 ** 30:.2f} GiB above the weights; layout "
                + ", ".join(f"{s}: {sorted(k)}" for s, k in reference_layout(name).items()))
        print(line)
        if "facebook/sam" in name:
            del feats
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            with torch.inference_mode():
                ms = cuda_ms(lambda: feature_fn(module, images), 1)
            peak = torch.cuda.max_memory_allocated() - base
            tokens = module.cfg.grid ** 2
            rows = min(tokens, SCORE_BLOCK_BYTES // (EXTRACTION_BATCH * module.cfg.num_heads * tokens * 4))
            print(f"  {name} at the extraction's default batch {EXTRACTION_BATCH}: peak {peak / 2 ** 30:.2f} GiB "
                  f"above the weights ({torch.cuda.get_device_properties(0).total_memory / 2 ** 30:.1f} GiB card), "
                  f"{EXTRACTION_BATCH / ms * 1e3:.1f} images/s (one call); a global layer's float32 scores in "
                  f"blocks of {rows} of its {tokens} query rows ({SCORE_BLOCK_BYTES / 2 ** 30:.0f} GiB a block)")
        del module, feature_fn
        torch.cuda.empty_cache()

    # ViT-H: K7 32 a call at [B, 257, 16, 80], on the kernel path against
    # "einsum" (float32) and in bf16 against float32; a DeiT teacher: K1 12 a call
    vit_h, _ = get_model(VIT_H, device=device, generator=torch.Generator(device).manual_seed(0))
    with torch.device(device):
        einsum_h = fvit._ViTTeacher(dataclasses.replace(fvit.VIT_HUGE, attention_impl="einsum"), resample="linear")
        bf16_h = fvit._ViTTeacher(fvit.VIT_HUGE, dtype=torch.bfloat16, resample="linear")
    for m in (einsum_h, bf16_h):
        m.load_state_dict(vit_h.state_dict())
        m.eval().requires_grad_(False)
    with torch.inference_mode():
        reset_attention_counts()
        tokens = vit_h(x)
        k_counts = attention_counts()
        want = einsum_h(x)
        e_counts = attention_counts()
        tokens_bf16 = bf16_h(x)
        b_counts = attention_counts()
    err = float((tokens - want).abs().max())
    rel = rel_l2(tokens_bf16.float(), tokens)
    print(f"  ViT-H tokens [{TEACHER_BATCH},257,1280]: kernel path (K7 {k_counts['flash_fwd']}) against \"einsum\" "
          f"(K7 {e_counts['flash_fwd'] - k_counts['flash_fwd']}): max_abs_err {err:.3e} (atol {MODEL_F32_ATOL}); "
          f"bf16 (K7 {b_counts['flash_fwd'] - e_counts['flash_fwd']}) against float32: rel_l2 {rel:.3e} "
          f"(< {MODEL_BF16_REL_L2})")
    check(k_counts == forward_only(32) and e_counts == k_counts and b_counts == forward_only(64),
          f"ViT-H launches {k_counts}, {e_counts}, {b_counts}")
    check(bool(torch.isfinite(tokens).all()) and err <= MODEL_F32_ATOL, "ViT-H's kernel path far from einsum")
    check(bool(torch.isfinite(tokens_bf16.float()).all()) and rel < MODEL_BF16_REL_L2, "ViT-H bf16 far from float32")
    del vit_h, einsum_h, bf16_h, tokens, want, tokens_bf16
    deit = fvit.get_deit_model(DEIT_TEACHER, device=device, generator=torch.Generator(device).manual_seed(0))
    with torch.inference_mode():
        reset_attention_counts()
        feature = fvit.get_deit_feature(deit, x)
        d_counts = attention_counts()
    print(f"  {DEIT_TEACHER}: feature {tuple(feature.shape)}, launches {d_counts}")
    check(d_counts == {**forward_only(0), "mha_fwd": 12} and tuple(feature.shape) == (TEACHER_BATCH, 768, 14, 14)
          and bool(torch.isfinite(feature).all()), f"{DEIT_TEACHER}: {d_counts}")
    del deit, feature
    torch.cuda.empty_cache()

    # K7 at ViT-H's shape against its plain version, float32 and bf16
    gen = torch.Generator(device=device).manual_seed(4)
    errors = {}
    for dtype in (torch.float32, torch.bfloat16):
        res = flash_case(attention, TEACHER_BATCH, 257, 16, 80, dtype, gen)
        for out in ("flash_fwd", "lse"):
            e, r, ok = flash_error(*res[out], dtype, out == "lse")
            check(ok, f"K7 {out} {dtype} [{TEACHER_BATCH},257,16,80] disagrees with its plain version")
            errors[(out, dtype)] = e
        print(f"  K7 flash_fwd {str(dtype).split('.')[-1]} [{TEACHER_BATCH},257,16,80] against flash_fwd_plain: "
              f"O max_abs_err {errors[('flash_fwd', dtype)]:.3e}, lse {errors[('lse', dtype)]:.3e}")

    # feature_extraction.main for the cddsv teachers over EXTRACT_SHARDS image shards
    usage = shutil.disk_usage(tmp)
    per_sample = sum(2 * math.prod(s) for t in teachers for s in reference_layout(t)[t.replace("/", "_")].values())
    need = EXTRACT_SHARDS * EXTRACT_SHARD_SIZE * (224 * 224 * 3 + per_sample) * 2
    check(usage.free >= need, f"{tmp} has {usage.free} bytes free, the phase needs {need}")
    generate_synthetic_dataset(tmp, feature_models={"x/y": (4, 4, 4)}, n_train=EXTRACT_SHARDS * EXTRACT_SHARD_SIZE,
                               n_val=EXTRACT_SHARD_SIZE, samples_per_shard=EXTRACT_SHARD_SIZE, write_stats=False)
    shutil.rmtree(os.path.join(tmp, "imagenet", "x_y"))
    ddir = os.path.join(tmp, "imagenet")

    def run_main(name):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            t0 = time.perf_counter()
            n = feature_extraction.main(["--dataset", "imagenet", "--split", "train", "--model", name,
                                         "--dataset-root", tmp, "--device", device])
            torch.cuda.synchronize()
        return n, time.perf_counter() - t0, out.getvalue()

    n_images = EXTRACT_SHARDS * EXTRACT_SHARD_SIZE
    reset_attention_counts()
    for name in teachers:
        n, wall, out = run_main(name)
        print(f"  feature_extraction.main --model {name}: {n} samples in {wall:.2f} s, {n / wall:.1f} images/s "
              f"end to end (the build, shard reads and writes included; host clock); "
              f"{out.count('using random init')} random-init warning")
        check(n == n_images and out.count("done (") == EXTRACT_SHARDS, f"{name}: extraction wrote {n}: {out}")
    counts = attention_counts()
    want = forward_only(32 * EXTRACT_SHARDS)
    print(f"  the extraction's launches: {counts}, expected {want} (ViT-H: one batch of {EXTRACT_SHARD_SIZE} a shard)")
    check(counts == want, "the extraction's launch counts")
    for name in teachers:
        n, wall, out = run_main(name)
        check(n == 0 and out.count("check pass, skipping") == EXTRACT_SHARDS, f"{name}: the rerun did not skip: {out}")
    print(f"  rerun: every teacher skipped its {EXTRACT_SHARDS} complete shards")
    for name in teachers:
        legit = name.replace("/", "_")
        mean, std = calc_feature_mean.compute_feature_stats(os.path.join(ddir, legit))
        c = get_model_feature_size(name)[0]
        check(mean.shape == std.shape == (c,) and bool(np.isfinite(mean).all()) and bool((std > 0).all()),
              f"{name}: feature stats {mean.shape}")
        np.save(os.path.join(tmp, f"imagenet_mean_{legit}.npy"), mean)
        np.save(os.path.join(tmp, f"imagenet_var_{legit}.npy"), std)
    ds, _ = get_image_video_dataset(dataset_root=tmp, feature_models=teachers, dataset_mix=["imagenet"],
                                    split="train", feature_norm=True, stats_root=tmp, seed=0)
    batch = next(iter(get_frame_dataloader(ds, batch_size=EXTRACT_SHARD_SIZE)))
    for name in teachers:
        c, hw = get_model_feature_size(name)
        emb = batch[name]["embedding"]
        check(tuple(emb.shape) == (EXTRACT_SHARD_SIZE, hw, c) and bool(torch.isfinite(emb.float()).all()),
              f"{name}: loaded {tuple(emb.shape)}")
    print(f"  compute_feature_stats over each teacher's shards, then the training loader's first batch of "
          f"{EXTRACT_SHARD_SIZE}: " + ", ".join(f"{t} {tuple(batch[t]['embedding'].shape)}" for t in teachers))
    for name in teachers:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            module, feature_fn = feature_extraction.build_teacher(name, device)
            ok = check_feature.check_shard(ddir, name, 0, np.array([0, 3, 5]), "train", module, feature_fn)
        line = [ln for ln in out.getvalue().splitlines() if "max|d|" in ln]
        print(f"  check_shard {name}, samples 0, 3, 5 of shard 0 regenerated as one batch of 3 (written in one "
              f"of {EXTRACT_SHARD_SIZE}): returns {ok}; {line[0] if line else out.getvalue()}")
        del module, feature_fn
        torch.cuda.empty_cache()
    return {"launches": counts, "errors": errors}

def translators_phase(card: str, tmp: str, teachers: list[str], reset_counts, read_counts, ln_pallas) -> dict:
    """Phase 9: the mlp, conv and transformer translators on Theia-Base
    cddsv at the configs' widths: served at B=16 in float32 and bf16 (shapes,
    finite values, bf16 within rel L2 MODEL_BF16_REL_L2 of float32), trained
    TRANSLATOR_STEPS steps of ``train_from_config`` at the recipe on phase
    6b's shards (finite losses, exact launch counts), the saved step loaded
    by ``load_theia_checkpoint`` into a fresh model whose predictions equal
    the same weights copied in; one exact-mode step of the conv translator
    (K1 = K2 = 12); and K3/K4 at the conv heads' LayerNormSpatial shapes
    against their plain versions, timed beside ``native_layer_norm_backward``
    and the bound. Returns those timings, keyed by (kernel, dtype, C, side)."""
    import os

    from theia_tpu_torch.models.hub import build_theia
    from theia_tpu_torch.models.pretrained import load_theia_checkpoint
    from theia_tpu_torch.train import loop
    from theia_tpu_torch.train.checkpoint import read_params
    from theia_tpu_torch.train.step import make_train_step
    from theia_tpu_torch.train.optim import make_optimizer
    from theia_tpu_torch.train.state import TrainState
    from theia_tpu_torch.foundation.common import get_model_feature_size
    from theia_tpu_torch.tools.timing import cuda_ms

    rng = np.random.default_rng(9)
    x16 = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    sizes = {t: get_model_feature_size(t, keep_spatial=True) for t in teachers}
    n_teachers = len(teachers)
    print(f"phase 9, the other translators: {MODEL}'s backbone with the mlp, conv and transformer translators at the "
          f"configs' widths ({card})")
    for name in TRANSLATORS:
        cfg = runtime_config(tmp, 1, (f"model/translator={name}",))
        kwargs = dict(cfg.model.translator.kwargs)
        gen = torch.Generator().manual_seed(9)
        f32 = build_theia(MODEL, translator=name, translator_kwargs=kwargs, generator=gen)
        n_params = sum(p.numel() for p in f32.translator.parameters())
        bf16 = build_theia(MODEL, translator=name, translator_kwargs=kwargs, dtype=torch.bfloat16,
                           param_dtype=torch.bfloat16)
        bf16.load_state_dict(f32.state_dict())
        with torch.inference_mode():
            p32, p16 = f32(x16), bf16(x16)
            ms32, ms16 = cuda_ms(lambda: f32(x16), 3), cuda_ms(lambda: bf16(x16), 3)
        rels = {}
        for t, (c, h, w) in sizes.items():
            for dn, p in (("float32", p32[t]), ("bf16", p16[t])):
                check(tuple(p.shape) == (TRAIN_BATCH, h * w, c) and bool(torch.isfinite(p.float()).all()),
                      f"{name} {dn} prediction of {t}: shape {tuple(p.shape)} or values")
            rels[t] = rel_l2(p16[t].float(), p32[t])
        print(f"  {name} {kwargs}: {n_params / 1e6:.1f}M translator parameters; serving B={TRAIN_BATCH}: float32 "
              f"{ms32:.2f} ms, bf16 {ms16:.2f} ms (CUDA events, 3 calls); predictions [16, H·W, C] finite; bf16 "
              f"against float32 rel_l2 " + ", ".join(f"{t.split('/')[-1]} {r:.2e}" for t, r in rels.items()) +
              f" (< {MODEL_BF16_REL_L2})")
        check(max(rels.values()) < MODEL_BF16_REL_L2, f"{name}: bf16 predictions far from float32")
        del f32, bf16, p32, p16
        torch.cuda.empty_cache()

        torch.cuda.reset_peak_memory_stats()
        summary, counts, _ = run_quietly(lambda: loop.train_from_config(cfg, max_steps=TRANSLATOR_STEPS),
                                         reset_counts, read_counts)
        peak = torch.cuda.max_memory_allocated()
        ln_sites = 3 * n_teachers if name == "conv" else 0
        want = {"mha_fwd": 0, "mha_bwd": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
                "ln_bwd_stats": ln_sites * TRANSLATOR_STEPS, "ln_bwd_dx": ln_sites * TRANSLATOR_STEPS,
                "loss_sums_fwd": n_teachers * (TRANSLATOR_STEPS + 1), "loss_sums_bwd": n_teachers * TRANSLATOR_STEPS,
                "loss_input_copies": 0}
        tm = summary["timing"]
        losses = [summary["train"]["loss"], *summary["eval"].values()]
        blocked = sum(b for _, b, _ in tm["saves"])
        print(f"  {name}, train_from_config at the recipe, {TRANSLATOR_STEPS} steps of {TRAIN_BATCH} + 1 eval + a "
              f"save: train loss {summary['train']['loss']:.6f}, eval cos {summary['eval']['avg_eval_cos_loss']:.6f}; "
              f"loop wall {tm['wall_s']:.3f} s, {(tm['wall_s'] - blocked) / tm['steps'] * 1e3:.1f} ms a step less "
              f"the {blocked:.3f} s save() blocked, {tm['images'] / (tm['wall_s'] - blocked):.1f} images/s; peak "
              f"memory allocated {peak / 1e9:.2f} GB; launches {counts}, expected {want} ({card})")
        check(all(math.isfinite(v) for v in losses), f"{name}: a loss is not finite")
        check(summary["step"] == TRANSLATOR_STEPS and counts == want, f"{name}: steps or launch counts are off")

        ckpt_dir = summary["ckpt_dir"]
        _, params = read_params(ckpt_dir)
        copied = build_theia(MODEL, translator=name, translator_kwargs=kwargs)
        copied.load_state_dict(params)
        t0 = time.perf_counter()
        loaded = load_theia_checkpoint(ckpt_dir, build_theia(MODEL, translator=name, translator_kwargs=kwargs,
                                                             generator=torch.Generator().manual_seed(10)))
        load_s = time.perf_counter() - t0
        tensors_equal = all(torch.equal(v, params[k].to(v.device)) for k, v in loaded.state_dict().items())
        # cuDNN's default algorithms for the heads' transposed convolutions
        # need not give the same bits twice; its deterministic ones do
        torch.backends.cudnn.deterministic = True
        try:
            with torch.inference_mode():
                a, b = copied(x16), loaded(x16)
        finally:
            torch.backends.cudnn.deterministic = False
        same = all(torch.equal(a[t], b[t]) for t in sizes)
        print(f"  {name}: load_theia_checkpoint of step {TRANSLATOR_STEPS} into a fresh model in {load_s:.3f} s; every "
              f"tensor equal to the file's: {tensors_equal}; its predictions (cuDNN deterministic) equal the same "
              f"weights copied in: {same}")
        check(tensors_equal and same, f"{name}: the loaded checkpoint differs from its weights")
        del copied, loaded, a, b, params
        shutil.rmtree(ckpt_dir, ignore_errors=True)
        torch.cuda.empty_cache()

    # one exact-mode step of the conv translator: K1 and K2 in the backbone
    cfg = runtime_config(tmp, 1, ("model/translator=conv",))
    model = build_theia(MODEL, translator="conv", translator_kwargs=dict(cfg.model.translator.kwargs),
                        dtype=torch.bfloat16, generator=torch.Generator().manual_seed(11))
    tx = make_optimizer(1e-4, moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model.train(), tx)
    targets = {t: torch.randn(TRAIN_BATCH, *sizes[t], device="cuda").to(torch.bfloat16) for t in teachers}
    reset_counts()
    state, metrics = step(state, x16, targets)
    torch.cuda.synchronize()
    counts = read_counts()
    n_layers = model.backbone.cfg.num_layers
    want = {"mha_fwd": n_layers, "mha_bwd": n_layers, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
            "ln_bwd_stats": 3 * n_teachers, "ln_bwd_dx": 3 * n_teachers, "loss_sums_fwd": n_teachers,
            "loss_sums_bwd": n_teachers, "loss_input_copies": 0}
    print(f"  conv, one exact-mode step (bf16 compute, attention \"pallas\"): loss {float(metrics['loss']):.6f}; "
          f"launches {counts}, expected {want}")
    check(math.isfinite(float(metrics["loss"])) and counts == want, "conv exact-mode step: loss or launch counts")
    del model, tx, state, step, targets, metrics
    torch.cuda.empty_cache()

    # K3/K4 at the conv heads' LayerNormSpatial shapes against their plain versions, then timed
    return ln_shape_rows(ln_pallas, TRAIN_BATCH, CONV_LN_SHAPES, card, torch.Generator(device="cuda").manual_seed(12))


def ln_shape_rows(ln_pallas, batch: int, shapes: tuple, card: str, gen: torch.Generator) -> dict:
    """K3 and K4 at [batch, C, side, side] for each (C, side) of ``shapes``,
    bf16 and float32, against their plain versions, then timed beside the
    plain versions, ``native_layer_norm_backward`` and the bound (the maps
    read once, the weight and the outputs once). Returns the rows, keyed by
    (kernel, dtype, C, side)."""
    from theia_tpu_torch.tools.timing import interleaved_ms

    rows = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[-1]
        for c, side in shapes:
            x, g, w, mean, r = ln_inputs(batch, c, side, dtype, gen)
            got = ln_pallas.ln_bwd_stats(x, w, mean, r, g)
            want = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
            shape = f"[{batch},{c},{side},{side}]"
            err3 = max(compare(f"K3 ln_bwd_stats {dn} {shape} {n}", a, bb, torch.float32)
                       for n, a, bb in zip(("s1", "s2", "dw", "db"), got, want))
            dx = ln_pallas.ln_bwd_dx(x, w, mean, r, g, want[0], want[1])
            err4 = compare(f"K4 ln_bwd_dx {dn} {shape}", dx, ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, *want[:2]),
                           dtype)
            s1, s2 = want[:2]
            xl, gl, wl = x.contiguous(), g.contiguous(), w.to(dtype)
            _, lmean, lrstd = torch.native_layer_norm(xl, wl.shape, wl, torch.zeros_like(wl), 1e-5)
            library = lambda: torch.ops.aten.native_layer_norm_backward(  # noqa: E731
                gl, xl, list(wl.shape), lmean, lrstd, wl, torch.zeros_like(wl), [True, True, True])
            maps, per_sample = x.numel() * x.element_size(), x[0].numel()
            for key, fns, nbytes, err in (
                    ("ln_bwd_stats", {"plain": lambda: ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g),
                                      "kernel": lambda: ln_pallas.ln_bwd_stats(x, w, mean, r, g), "library": library},
                     2 * maps + per_sample * 4 * 3, err3),
                    ("ln_bwd_dx", {"plain": lambda: ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2),
                                   "kernel": lambda: ln_pallas.ln_bwd_dx(x, w, mean, r, g, s1, s2),
                                   "library": library}, 3 * maps + per_sample * 4, err4)):
                t = interleaved_ms(fns, iters=10)
                bound, by = bound_ms(nbytes, 8 * x.numel(), dtype)
                rows[(key, dn, c, side)] = {"shape": [batch, c, side, side], "dtype": dn, "ms": t["kernel"],
                                            "plain_ms": t["plain"], "library_ms": t["library"], "bound_ms": bound,
                                            "bound_by": by, "max_abs_err": err}
                print(f"    {'K3' if key == 'ln_bwd_stats' else 'K4'} {key} {dn} {shape}: kernel {t['kernel']:.4f} ms, "
                      f"plain {t['plain']:.4f} ms, native_layer_norm_backward {t['library']:.4f} ms, bound "
                      f"{bound * 1e3:.1f} us ({by}, {nbytes / 1e6:.1f} MB), bound / kernel "
                      f"{100 * bound / t['kernel']:.1f}% ({card})")
            del x, g, w, mean, r, got, want, dx, xl, gl, wl, lmean, lrstd
            torch.cuda.empty_cache()
    return rows


def decoding_phase(card: str) -> None:
    """Phase 10: decoding a student's predictions. A Theia-Base cddsv lconv
    student (seeded random weights), the full ``SamDecoderConfig`` mask
    decoder and the Depth-Anything-L head tail, and the full-width DINOv2-L,
    SAM-H and Depth-Anything-L teachers for the ground-truth row, on B =
    DECODE_BATCH uint8 224² images: both rows' panels; the card's mask
    decoder against the same decoder on the CPU; AMG at
    AMG_POINTS_PER_SIDE at the defaults and with both thresholds at their
    minimum (every mask through filter_masks, box_nms and the RLE round
    trip); the time of each decoder and of ``decode_everything``."""
    import copy

    from theia_tpu_torch.decoding import (decode_depth_anything, decode_dinov2, decode_everything, decode_sam,
                                          prepare_depth_decoder, prepare_mask_generator, run_gt_teachers)
    from theia_tpu_torch.decoding import sam as sam_decoding
    from theia_tpu_torch.decoding.amg import box_nms, build_point_grid, mask_to_rle
    from theia_tpu_torch.decoding.decode import DEPTH, DINO, SAM
    from theia_tpu_torch.decoding.dinov2 import PCA, _minmax_columns
    from theia_tpu_torch.foundation.extraction import get_model
    from theia_tpu_torch.models.hub import build_theia
    from theia_tpu_torch.tools.timing import cuda_ms

    t0 = time.perf_counter()
    student = build_theia(MODEL, generator=torch.Generator().manual_seed(12))
    teachers = {name: get_model(name, device="cuda", generator=torch.Generator("cuda").manual_seed(0))[0]
                for name in (DINO, SAM, DEPTH)}
    mask_generator, decoder = prepare_mask_generator(generator=torch.Generator("cuda").manual_seed(13),
                                                     points_per_side=AMG_POINTS_PER_SIDE)
    depth_decoder, _ = prepare_depth_decoder(module=teachers[DEPTH])
    torch.cuda.synchronize()
    print(f"phase 10, decoding: {MODEL} student, the full SAM mask decoder (seeded, "
          f"{sum(p.numel() for p in decoder.parameters()) / 1e6:.2f}M parameters), Depth-Anything-L's head tail, "
          f"DINOv2-L, SAM-H and Depth-Anything-L for the ground truth, built in {time.perf_counter() - t0:.1f} s; "
          f"B={DECODE_BATCH} uint8 224² images ({card})")
    images = np.random.default_rng(10).integers(0, 256, (DECODE_BATCH, 224, 224, 3), dtype=np.uint8)
    sizes = student.translator.target_feature_sizes
    means = {t: np.zeros(c, np.float32) for t, (c, _, _) in sizes.items()}
    stds = {t: np.ones(c, np.float32) for t, (c, _, _) in sizes.items()}

    @torch.inference_mode()
    def theia_forward(x):
        return student(x)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, gt_rows = decode_everything(theia_forward, means, stds, images, mask_generator, depth_decoder, gt=True,
                                      gt_teacher_modules=teachers, rng=np.random.RandomState(0))
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    for label, panels in (("predicted", rows), ("ground truth", gt_rows)):
        check(len(panels) == DECODE_BATCH, f"{label}: {len(panels)} panels")
        for p in panels:
            sam_part = p[:, 448:672]
            rest = np.concatenate([p[:, :448], p[:, 672:]], axis=1)
            check(p.shape == (224, 896, 3) and bool(np.isfinite(p).all()), f"{label} panel {p.shape}")
            check(float(rest.min()) >= 0.0 and float(rest.max()) <= 1.0 and float(sam_part.min()) >= 0.0,
                  f"{label} panel out of [0, 1]: " + ", ".join(
                      f"{part} [{float(p[:, i:i + 224].min())!r}, {float(p[:, i:i + 224].max())!r}]"
                      for part, i in (("image", 0), ("dinov2", 224), ("sam", 448), ("depth", 672))))
    over = sum(int((p[:, 448:672] > 1.0).sum()) for p in rows + gt_rows)
    print(f"  decode_everything(gt=True): {total_s:.2f} s end to end (host clock) for {DECODE_BATCH} images, both "
          f"rows [224, 896, 3] finite in [0, 1] (the mask panels' values above 1, where masks overlap: {over})")

    with torch.inference_mode():
        gt = run_gt_teachers(images, modules=teachers)
        feats = {k: v.float() for k, v in theia_forward(images).items()}
        again = theia_forward(images)[DINO].float()
    # the predicted row's min-max: its tokens projected onto the ground truth's PCA, beside sklearn's
    # x * scale - min * scale, which can round above 1
    proj = PCA(3).fit(gt[DINO].flatten(0, 1)).transform(feats[DINO].flatten(0, 1))
    proj = proj[proj[:, 0] >= -100]
    lo, hi = proj.amin(dim=0), proj.amax(dim=0)
    scale = 1.0 / (hi - lo)
    sk_formula = proj * scale + (0.0 - lo * scale)
    print(f"  decode_dinov2 on the predicted row: columns' |min| / (max - min) "
          f"{[round(float(v), 2) for v in lo.abs() / (hi - lo)]}; sklearn's formula's range "
          f"[{float(sk_formula.min())!r}, {float(sk_formula.max())!r}], the port's "
          f"[{float(_minmax_columns(proj).min())!r}, {float(_minmax_columns(proj).max())!r}]; two student "
          f"forwards' DINOv2 predictions max_abs {float((again - feats[DINO]).abs().max()):.3e} ({card})")
    ms = {}
    ms["decode_dinov2"] = _host_ms(lambda: decode_dinov2(feats[DINO]))
    ms["decode_depth_anything"] = _host_ms(lambda: decode_depth_anything(feats[DEPTH], depth_decoder))
    ms["decode_sam (defaults of decode_everything, one image)"] = _host_ms(
        lambda: decode_sam(feats[SAM][:1], [None], mask_generator, pred_iou_thresh=0.9, stability_score_thresh=0.9))

    # the card's decoder against the same decoder on the CPU, float32, at one point batch
    emb = gt[SAM][:1].transpose(1, 2).reshape(1, 256, 64, 64).permute(0, 2, 3, 1).contiguous()
    pts = torch.from_numpy((build_point_grid(8) * 1024).astype(np.float32))[None, :, None, :].cuda()
    lbl = torch.ones(pts.shape[:3], dtype=torch.int32, device="cuda")
    cpu_decoder = copy.deepcopy(decoder).cpu()
    with torch.inference_mode():
        masks, iou = decoder(emb, pts, lbl)
        cmasks, ciou = cpu_decoder(emb.cpu(), pts.cpu(), lbl.cpu())
        decoder(emb, pts, lbl)
        dec_ms = cuda_ms(lambda: decoder(emb, pts, lbl), 5)
    merr, ierr = float((masks.cpu() - cmasks).abs().max()), float((iou.cpu() - ciou).abs().max())
    print(f"  SamMaskDecoder [1, {pts.shape[1]}, 1, 2] points: the card against the CPU, low-res masks "
          f"{tuple(masks.shape)} max_abs {merr:.3e} (atol {DECODER_MASK_ATOL}), IoU max_abs {ierr:.3e} (atol "
          f"{DECODER_IOU_ATOL}); {dec_ms:.3f} ms a call on the card (CUDA events, 5 calls) ({card})")
    check(merr <= DECODER_MASK_ATOL and ierr <= DECODER_IOU_ATOL, "the card's mask decoder disagrees with the CPU's")
    del cpu_decoder

    # AMG on the ground-truth SAM embedding at the defaults, then with both
    # thresholds off; the masks box_nms sees are counted on the way in
    emb_bchw = gt[SAM][:1].transpose(1, 2).reshape(1, 256, 64, 64)
    seen = []

    def counting_nms(boxes, scores, thresh):
        seen.append(len(boxes))
        return box_nms(boxes, scores, thresh)

    sam_decoding.box_nms = counting_nms
    for label, kw in (("defaults (0.88, 0.95)", {}),
                      ("thresholds at their minimum (0, 0)", dict(pred_iou_thresh=0.0, stability_score_thresh=0.0))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = mask_generator(emb_bchw, output_rle_mask=True, output_bboxes_mask=True, **kw)
        amg_s = time.perf_counter() - t0
        n = len(out["masks"])
        ok = all(m.shape == (224, 224) and m.dtype == bool for m in out["masks"])
        if n:
            again = mask_to_rle(torch.from_numpy(np.stack(out["masks"])).cuda())
            ok = ok and again == out["rle_mask"]
        into = seen.pop() if seen else 0
        print(f"  AMG at {AMG_POINTS_PER_SIDE}² points, {label}: {into} masks passed filter_masks, {n} kept by "
              f"box_nms, in {amg_s:.2f} s (host clock); masks [224, 224] bool, their RLEs round-trip: {ok}")
        check(ok, f"AMG {label}: masks or their RLE round trip")
        if kw:
            check(n > 0 and into > n, "AMG with the thresholds off: no mask set for box_nms")
    sam_decoding.box_nms = box_nms
    print("  decoders, host clock around each synchronous call (mean of 3): " +
          "; ".join(f"{k} {v:.1f} ms" for k, v in ms.items()) + f" ({card})")
    del student, teachers, mask_generator, decoder, depth_decoder, gt, feats
    torch.cuda.empty_cache()


def data_parallel_phase(card: str, tmp: str, teachers: list[str]) -> dict:
    """Phase 11: data parallelism. (a) ``torchrun -m
    theia_tpu_torch.scripts.train_rvfm`` at one process on phase 6b's
    shards: 3 steps and the save (one process makes no process group); then
    the NCCL branch of the step's collectives on a one-rank NCCL group: the
    bf16 gradient bucket, the metrics' all-reduce, the barrier and the
    broadcast. (b) Two gloo ranks on this one card
    (``tools/two_rank_step.py``): the ranks' parameters and moments
    bit-equal after each wire's steps, the losses against one process on
    the whole batch, exact mode's all-reduced gradient against the whole
    batch's, each rank's step and all-reduce times and launches. Returns
    (b)'s records."""
    import os
    import socket

    import torch.distributed as dist

    from theia_tpu_torch.parallel.distributed import barrier, broadcast_module
    from theia_tpu_torch.train import step as tstep
    from theia_tpu_torch.train.checkpoint import all_steps
    from theia_tpu_torch.tools import two_rank_step

    def free_port() -> int:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            return sock.getsockname()[1]

    # (a) the CLI under torchrun, one process
    run = "torchrun1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node=1", "-m",
           "theia_tpu_torch.scripts.train_rvfm", *RUNTIME_OVERRIDES, f"dataset.dataset_root={tmp}",
           f"training.batch_size={DP_CLI_BATCH}", "training.epochs=1", f"logging.model_path={tmp}/ckpt",
           f"logging.log_path={tmp}/logs", f"logging.run_identifier_prefix={run}"]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, OMP_NUM_THREADS="1"))
    cli_s = time.perf_counter() - t0
    check(out.returncode == 0, f"torchrun train_rvfm failed ({out.returncode}):\n{out.stdout[-3000:]}\n"
                               f"{out.stderr[-3000:]}")
    steps = RUNTIME_TRAIN // DP_CLI_BATCH
    saved = all_steps(os.path.join(tmp, "ckpt", run))
    stepped = f"'step': {steps}," in out.stdout
    print(f"phase 11, data parallelism: (a) torchrun --nproc_per_node=1 -m theia_tpu_torch.scripts.train_rvfm, "
          f"{MODEL} at the recipe, batch {DP_CLI_BATCH} on phase 6b's shards: {cli_s:.1f} s for the whole command "
          f"(the process's start included); committed steps {saved}; the printed summary ends at step {steps}: "
          f"{stepped}")
    check(saved == [steps] and stepped, "the torchrun run did not save its last step")

    # the NCCL branch on a one-rank group (NCCL refuses two ranks on one card)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0,
                            device_id=torch.device("cuda", 0))
    try:
        gen = torch.Generator(device="cuda").manual_seed(13)
        grads = {"a": torch.randn(1000, 7, device="cuda", generator=gen), "b": torch.randn(33, device="cuda",
                                                                                          generator=gen)}
        wire = tstep.all_reduce_grads(grads, 1, torch.bfloat16)
        metrics = tstep.mean_over_ranks({"loss": grads["b"][0], "per": {"t": grads["b"][1]}}, 2)
        module = torch.nn.Linear(3, 2).cuda()
        before = [p.clone() for p in module.parameters()]
        barrier()
        broadcast_module(module)
        torch.cuda.synchronize()
        ok = (all(torch.equal(wire[k], g.bfloat16().float()) for k, g in grads.items())
              and float(metrics["loss"]) == float(grads["b"][0]) / 2
              and all(torch.equal(a, b) for a, b in zip(before, module.parameters())))
        print(f"  the NCCL branch at one rank ({dist.get_backend()}): the bf16 bucket of 7033 elements comes back as "
              f"each gradient rounded to bf16, the metrics' all-reduce sums then divides, barrier and broadcast "
              f"run: {ok}")
        check(ok, "the collectives on a one-rank NCCL group")
    finally:
        dist.destroy_process_group()

    # (b) two gloo ranks on this card
    out_dir = Path(tmp) / "two_ranks"
    port = free_port()
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, "-m", "theia_tpu_torch.tools.two_rank_step", "--out",
                                       str(out_dir), "--rows", str(DP_ROWS), "--steps", str(DP_STEPS)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    two_s = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"two_rank_step rank {rank} failed ({p.returncode}):\n{log[-4000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(2)]

    # one process on the whole batch: the same steps from the same start
    images, targets = two_rank_step.global_batch(2 * DP_ROWS)
    model, tx, state = two_rank_step.build_model(two_rank_step.RECIPE)
    step = tstep.make_train_step(model, tx)
    one = []
    for _ in range(DP_STEPS):
        state, m = step(state, images, targets)
        one.append(float(m["loss"]))
    del model, tx, state, step
    torch.cuda.empty_cache()

    n_ln, n_teachers = 15, len(teachers)
    want = {"mha_fwd": 0, "mha_bwd": 0, "ln_bwd_stats": n_ln * DP_STEPS, "ln_bwd_dx": n_ln * DP_STEPS,
            "loss_sums_fwd": n_teachers * DP_STEPS, "loss_sums_bwd": n_teachers * DP_STEPS}
    print(f"  (b) two gloo ranks on one card (both cuda:0), {DP_ROWS} rows each of a global batch of {2 * DP_ROWS}, "
          f"{MODEL} at the recipe, {DP_STEPS} steps a wire dtype; {two_s:.1f} s for both processes ({card})")
    print(f"  one process on the whole batch: losses {' '.join(f'{x:.6f}' for x in one)}")
    for wire in ("bfloat16", "float32"):
        r0, r1 = ranks[0][wire], ranks[1][wire]
        share = [sum(r[wire]["allreduce_ms"][1:]) / sum(r[wire]["step_ms"][1:]) for r in ranks]
        print(f"  {wire} wire: losses {' '.join(f'{x:.6f}' for x in r0['losses'])}; one all_reduce of "
              f"{r0['n_params']} {wire} elements a step; parameters bit-equal on both ranks: {r0['params_equal']}, "
              f"Adam moments: {r0['moments_equal']}; launches a rank {r0['launches']} (expected {want})")
        for rank, r in enumerate((r0, r1)):
            print(f"    rank {rank}: step ms {' '.join(f'{x:.1f}' for x in r['step_ms'])}, gradient all-reduce ms "
                  f"{' '.join(f'{x:.1f}' for x in r['allreduce_ms'])} (gloo, host-staged), its share of steps 2-"
                  f"{DP_STEPS} {100 * share[rank]:.1f}% (CUDA events)")
        check(r0["params_equal"] and r0["moments_equal"] and r0["losses"] == r1["losses"],
              f"{wire} wire: the ranks' parameters, moments or losses differ")
        check(r0["launches"] == want == r1["launches"], f"{wire} wire: launch counts are off")
        check(np.allclose(r0["losses"], one, rtol=DP_LOSS_RTOL), f"{wire} wire: losses far from one process's")
        ex = ranks[0][f"exact_{wire}"]
        print(f"  exact mode (float32 compute), one step, {wire} wire: the all-reduced gradient bit-equal to the "
              f"{wire} sum of the ranks' local gradients each halved and cast: {ex['wire_bit_equal']} (max abs "
              f"{ex['wire_max_abs']:.3e}); against one process's on the whole batch rel_l2 "
              f"{ex['grad_rel_l2_whole']:.3e} (< {TRAIN_GRAD_REL_L2}); loss {ex['loss']:.6f}")
        check(ex["wire_bit_equal"] and ex["grad_rel_l2_whole"] < TRAIN_GRAD_REL_L2,
              f"{wire} wire: the all-reduced gradient is not the ranks' or far from one process's")
    return {"ranks": ranks, "one_process": one, "cli_s": cli_s}


def downstream_phase(card: str, model, reset_counts, read_counts) -> dict:
    """Phase 12, the downstream modules: ``load_model`` on phase 4's
    full-width Theia-Base cddsv ((768, 14, 14), its B=1 p50); the two
    CortexBench heads' forward and backward at B=32 through K3/K4 (exact
    launch counts) against their plain backward; a VFMEncoder over DINOv2-L
    and a ConcatVFMEncoder over DINOv2-L and CLIP-L at B=8 (seeded weights)."""
    from theia_tpu_torch.models import layers
    from theia_tpu_torch.models.vfm import ConcatVFMEncoder, VFMEncoder
    from theia_tpu_torch.tools.timing import cuda_ms
    from theia_tpu_torch.utils.cortexbench import ConvBatchNormMLP, ConvPolicyHead, load_model, rvfm_image_transforms

    forward_feature, dim, transform, _ = load_model(model, rvfm_image_transforms())
    rng = np.random.default_rng(12)
    img = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    x1 = torch.from_numpy(transform(img)[None]).cuda()
    p50, lo, hi = latency_b1(forward_feature, x1)
    feats = forward_feature(x1)
    print(f"phase 12, downstream: load_model on {MODEL} (float32): embedding {dim}, a 300x400 image through "
          f"rvfm_image_transforms -> {tuple(x1.shape)} -> features {tuple(feats.shape)}; B=1 forward p50 {p50:.3f} ms "
          f"(min {lo:.3f}, max {hi:.3f}, 50 calls) ({card})")
    check(dim == (768, 14, 14) and tuple(feats.shape) == (1, 196, 768) and bool(torch.isfinite(feats).all()),
          "load_model: embedding dim or features")

    records = {}
    c, h, w = dim
    for cls, n_ln in ((ConvBatchNormMLP, 3), (ConvPolicyHead, 2)):
        head = cls(embedding_dim=dim, proprio_dim=HEAD_PROPRIO, history_window=HEAD_HISTORY,
                   action_dim=HEAD_ACTIONS).cuda()
        obs = torch.randn(HEAD_BATCH, HEAD_HISTORY * h * w * c + HEAD_PROPRIO, device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(14))
        grads = {}
        for impl in ("pallas", "vpu"):
            layers.LN_STATS_IMPL = impl
            try:
                x = obs.clone().requires_grad_(True)
                head.zero_grad()
                reset_counts()
                action = head(x)
                action.square().sum().backward()
                torch.cuda.synchronize()
                counts = read_counts()
            finally:
                layers.LN_STATS_IMPL = "pallas"
            lns = [m for m in head.modules() if isinstance(m, layers.LayerNormSpatial)]
            grads[impl] = dict(dx=x.grad, action=action.detach(),
                               **{f"dw{i}": m.weight.grad for i, m in enumerate(lns)},
                               **{f"db{i}": m.bias.grad for i, m in enumerate(lns)})
            if impl == "pallas":
                launched = (counts["ln_bwd_stats"], counts["ln_bwd_dx"])
        errs = {k: float((grads["pallas"][k] - v).abs().max()) for k, v in grads["vpu"].items()}
        ms = cuda_ms(lambda: head(obs.requires_grad_(False)).square().sum().backward(), 5)
        print(f"  {cls.__name__} (history {HEAD_HISTORY}, proprio {HEAD_PROPRIO}, B={HEAD_BATCH}, float32): forward "
              f"and backward, K3/K4 launches {launched} (expected ({n_ln}, {n_ln})); kernel path against the plain "
              f"backward, max abs: " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) +
              f" (atol {HEAD_F32_ATOL}); forward + backward {ms:.3f} ms (CUDA events, 5 calls)")
        check(launched == (n_ln, n_ln), f"{cls.__name__}: K3/K4 launch counts")
        check(max(errs.values()) < HEAD_F32_ATOL and bool(torch.isfinite(grads["pallas"]["dx"]).all()),
              f"{cls.__name__}: the kernel path's gradients differ from the plain backward")
        records[cls.__name__] = dict(launches=launched, max_abs_err=max(errs.values()), ms=ms)
        del head, obs, grads
        torch.cuda.empty_cache()

    images = torch.from_numpy(rng.integers(0, 256, (VFM_BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
    dino = VFMEncoder("facebook/dinov2-large", generator=torch.Generator(device="cuda").manual_seed(15))
    both = ConcatVFMEncoder(["facebook/dinov2-large", "openai/clip-vit-large-patch14"],
                            generator=torch.Generator(device="cuda").manual_seed(16))
    for name, enc, want in (("VFMEncoder(dinov2-large)", dino, (VFM_BATCH, 256, 1024)),
                            ("ConcatVFMEncoder(dinov2-large, clip-vit-large)", both, (VFM_BATCH, 256, 2048))):
        out = enc.forward_feature(images)
        ms = cuda_ms(lambda: enc.forward_feature(images), 3)
        print(f"  {name} forward_feature at B={VFM_BATCH} uint8 224²: {tuple(out.shape)}, finite "
              f"{bool(torch.isfinite(out).all())}; {ms:.2f} ms (CUDA events, 3 calls), {VFM_BATCH / ms * 1e3:.1f} "
              f"images/s ({card})")
        check(tuple(out.shape) == want and bool(torch.isfinite(out).all()), f"{name}: shape or values")
        records[name] = ms
    del dino, both
    torch.cuda.empty_cache()
    records["load_model_b1_p50_ms"] = p50
    return records


def tp_predicted(translator: str, n_heads: int, n_layers: int = 12) -> tuple[dict, int]:
    """The launches a recipe step and the model-group all-reduces a step
    predicted for ``translator`` before the first run: K3/K4 3 a conv or
    lconv head, K5/K6 one a head; the all-reduces 2 a block each way, then
    for each head its row-parallel outputs, split LayerNorm sums and split
    loss sums forward, its column-parallel inputs and split LayerNorm sums
    back (lconv and conv 3 + 3, a 3-layer mlp head 2 + 2, the transformer's
    2-layer head 1 + 1), and the replicated gradients' bucket."""
    ln = 3 * n_heads if translator in ("lconv", "conv") else 0
    per_head = {"lconv": 6, "conv": 6, "mlp": 4, "transformer": 2}[translator]
    launches = {"mha_fwd": 0, "mha_bwd": 0, "ln_bwd_stats": ln, "ln_bwd_dx": ln,
                "loss_sums_fwd": n_heads, "loss_sums_bwd": n_heads}
    return launches, 4 * n_layers + per_head * n_heads + 1


def tp_plan_all_reduces(split: dict) -> int:
    """The model-group all-reduces a step the cut's split layers give
    (``tools/tp_step.split_layers``): 2 a block each way, a row-parallel
    output and a split loss forward, a column-parallel input back, a split
    LayerNorm's sums both ways, and the replicated gradients' bucket."""
    return (4 * split["blocks"] + split["row"] + split["col"] + 2 * split["ln_shard"]
            + split["split_outputs"] + 1)


def tensor_parallel_phase(card: str, teachers: list[str], ln_pallas) -> dict:
    """Phase 13: tensor parallelism. K4 against its plain version with the
    normaliser's count apart from the row length, at the split ladders'
    shapes, and K3/K4 timed there; then one pair of gloo ranks at
    ``model_axis=2`` on this card (``tools/tp_step.py``) for each of
    TP_TRANSLATORS in turn: the losses and the gathered parameters' change
    against one process's, the replicated parameters bit-equal on both
    ranks, the launches and the audit's model-group records against the
    prediction and the plan, each rank's step time, the share of it in the
    all-reduces and its peak memory; ``tp_step.EXACT_TRANSLATORS``'
    exact-mode launches and gradient against one process's. Returns the
    ranks' records and the K3/K4 rows."""
    import os
    import socket

    from theia_tpu_torch.tools import two_rank_step
    from theia_tpu_torch.tools.tp_step import EXACT_TRANSLATORS
    from theia_tpu_torch.train.step import make_train_step

    gen = torch.Generator(device="cuda").manual_seed(23)
    print(f"phase 13, tensor parallelism ({card}):")
    for c, side in TP_LN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[-1]
            x, g, w, mean, r = ln_inputs(TRAIN_BATCH, c, side, dtype, gen)
            s1, s2, _, _ = ln_pallas.ln_bwd_stats_plain(x, w, mean, r, g)
            count = 2 * x[0].numel()
            dx = ln_pallas.ln_bwd_dx(x, w, mean, r, g, s1, s2, count)
            torch.cuda.synchronize()
            compare(f"K4 ln_bwd_dx {dn} [{TRAIN_BATCH},{c},{side},{side}], N = {count} (twice the row)", dx,
                    ln_pallas.ln_bwd_dx_plain(x, w, mean, r, g, s1, s2, count), dtype)
    del x, g, w, mean, r, s1, s2, dx
    torch.cuda.empty_cache()
    print("  K3 and K4 at a rank's split ladder maps, timed (N the row: the count changes one scalar):")
    ln_rows = ln_shape_rows(ln_pallas, TRAIN_BATCH, TP_LN_SHAPES, card, gen)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out_dir = Path(tempfile.mkdtemp(prefix="theia_tp_"))
    procs = []
    t0 = time.perf_counter()
    for rank in range(2):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK="0", WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "theia_tpu_torch.tools.tp_step", "--out", str(out_dir), "--rows", str(TP_ROWS),
             "--steps", str(TP_STEPS), "--translators", ",".join(TP_TRANSLATORS)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    two_s = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"tp_step rank {rank} failed ({p.returncode}):\n{log[-4000:]}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text())["translators"] for r in range(2)]
    print(f"  one pair of gloo ranks on one card (both cuda:0), model_axis=2, both on one global batch of {TP_ROWS}, "
          f"{MODEL} at the recipe, {TP_STEPS} steps of each of {', '.join(TP_TRANSLATORS)}; {two_s:.1f} s for both "
          f"processes ({card})")

    images, targets = two_rank_step.global_batch(TP_ROWS)
    flat = lambda tree: torch.cat([t.detach().reshape(-1).float().cuda() for t in tree.values()])  # noqa: E731
    n_heads = len(teachers)
    for t in TP_TRANSLATORS:
        r0, r1 = ranks[0][t], ranks[1][t]
        # one process on the same batch, from the same start
        cut = torch.load(out_dir / f"params_{t}.pt", weights_only=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        model, tx, state = two_rank_step.build_model(two_rank_step.RECIPE, translator=t)
        init = flat(state.params)
        step = make_train_step(model, tx)
        one = {"losses": []}
        for _ in range(TP_STEPS):
            state, m = step(state, images, targets)
            one["losses"].append(float(m["loss"]))
        one["peak_bytes"] = torch.cuda.max_memory_allocated() - held
        want_p = flat(state.params)
        one["change_rel_l2"] = float((flat(cut) - want_p).norm() / (want_p - init).norm())
        del model, tx, state, step, cut, init, want_p
        torch.cuda.empty_cache()

        rec = r0["recipe"]
        want, predicted_ars = tp_predicted(t, n_heads)
        want = {k: v * TP_STEPS for k, v in want.items()}
        plan_ars = tp_plan_all_reduces(rec["split_layers"])
        print(f"  {t}: {rec['n_split']} of {rec['n_params']} parameters split, {rec['local_elements']} elements a "
              f"rank; split layers {rec['split_layers']}")
        print(f"    losses {' '.join(f'{x:.6f}' for x in rec['losses'])}; one process on the same batch "
              f"{' '.join(f'{x:.6f}' for x in one['losses'])} (rtol {DP_LOSS_RTOL}); the gathered parameters' "
              f"change against one process's: rel_l2 {one['change_rel_l2']:.3e} (< {TP_CHANGE_REL_L2})")
        for rank, rr in enumerate((r0, r1)):
            rc = rr["recipe"]
            share = sum(map(sum, rc["allreduce_ms"][1:])) / sum(rc["step_ms"][1:])
            bucket = [ms[-1] for ms in rc["allreduce_ms"]]
            print(f"    rank {rank}: step ms {' '.join(f'{x:.1f}' for x in rc['step_ms'])}; "
                  f"{len(rc['allreduce_ms'][0])} model-group all-reduces a step "
                  f"({sum(rc['allreduce_bytes'][0]) / 2**20:.1f} MiB), their share of steps 2-{TP_STEPS} "
                  f"{100 * share:.1f}% (CUDA events, gloo's host staging included), of which the replicated "
                  f"gradients' bucket {' '.join(f'{x:.1f}' for x in bucket)} ms; peak memory "
                  f"{rc['peak_bytes'] / 2**30:.2f} GiB (one process's {one['peak_bytes'] / 2**30:.2f} GiB above "
                  f"what the script held); replicated parameters bit-equal on both ranks: "
                  f"{rc['replicated_equal']}; launches {rc['launches']}")
        sp = rec["replicated_grad_spread"]
        print(f"    recipe: the ranks' replicated gradients before the bucket that averages them: {sp['differ']} of "
              f"{sp['elements']} elements differ, max abs {sp['max_abs']:.3e}")
        print(f"    audit of the first recipe step on rank 0: {rec['audit']} (model-group all-reduces: the plan's "
              f"{plan_ars}, predicted {predicted_ars})")
        check(rec["losses"] == r1["recipe"]["losses"], f"{t}: the ranks' losses differ")
        check(np.allclose(rec["losses"], one["losses"], rtol=DP_LOSS_RTOL), f"{t}: TP losses far from one process's")
        check(one["change_rel_l2"] < TP_CHANGE_REL_L2, f"{t}: TP parameters' change far from one process's")
        check(rec["replicated_equal"] and r1["recipe"]["replicated_equal"],
              f"{t}: the replicated parameters differ across the model group")
        check(rec["launches"] == want == r1["recipe"]["launches"], f"{t}: TP launch counts are off (expected {want})")
        check(rec["audit"] == {"all-reduce@g2": rec["audit"].get("all-reduce@g2", {})}
              and rec["audit"]["all-reduce@g2"]["count"] == plan_ars == predicted_ars,
              f"{t}: the audit's model-group records are off")
        if t in EXACT_TRANSLATORS:
            ex = r0["exact"]
            sp = ex["replicated_grad_spread"]
            n_layers = 12
            want_exact = {"mha_fwd": n_layers, "mha_bwd": n_layers, "ln_bwd_stats": 3 * n_heads,
                          "ln_bwd_dx": 3 * n_heads, "loss_sums_fwd": n_heads, "loss_sums_bwd": n_heads}
            print(f"    exact mode (float32 compute), one step: the gathered gradient against one process's rel_l2 "
                  f"{ex['grad_rel_l2_whole']:.3e} (< {TRAIN_GRAD_REL_L2}); loss {ex['loss']:.6f}; launches "
                  f"{ex['launches']}; replicated gradients before the bucket: {sp['differ']} of {sp['elements']} "
                  f"differ, max abs {sp['max_abs']:.3e}")
            check(ex["grad_rel_l2_whole"] < TRAIN_GRAD_REL_L2, f"{t}: the TP gradient is far from one process's")
            check(ex["launches"] == want_exact == r1["exact"]["launches"],
                  f"{t}: exact-mode TP launch counts are off (expected {want_exact})")
    shutil.rmtree(out_dir, ignore_errors=True)
    return {"ranks": ranks, "seconds": two_s, "ln_rows": ln_rows}


def _host_ms(fn, iters: int = 3) -> float:
    """Mean host milliseconds of a synchronous call after one warm call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main() -> int:
    t_start = time.perf_counter()

    def stamp(phase: str) -> None:
        """The script's elapsed time at the end of a phase (host clock), so
        that its growth against the time limit shows phase by phase."""
        print(f"[{phase} done at {time.perf_counter() - t_start:.1f} s]")

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

    stamp("phases 1-2")
    # phase 3: kernel vs plain; float32 phases run with TF32 off
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print("TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, torch.backends.cudnn.allow_tf32 = False")
    kernel_errors = compare_kernels(attention, ln_pallas)
    kernel_errors.update(compare_flash_kernels(attention))
    _, teachers = parse_model_name(MODEL)
    teacher_dims = [math.prod(get_model_feature_size(t, keep_spatial=True)) for t in teachers]
    kernel_errors.update(compare_loss_kernels(fused_loss, teacher_dims))
    # K3/K4 at the policy heads' shapes: C = 60 (one element a thread) and 1x1 maps
    print(f"  K3/K4 at the CortexBench policy heads' LayerNormSpatial shapes, B={POLICY_BATCH}:")
    policy_ln_rows = ln_shape_rows(ln_pallas, POLICY_BATCH, POLICY_LN_SHAPES, card,
                                   torch.Generator(device="cuda").manual_seed(17))

    stamp("phase 3")
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

    def attention_model(impl: str, build=build_theia, **kw):
        """``build(MODEL, **kw)`` (``build_theia`` or ``from_pretrained``) with
        the backbone's ``attention_impl`` set to ``impl``."""
        vit.BACKBONE_CONFIGS[backbone_name] = dataclasses.replace(saved_cfg, attention_impl=impl)
        try:
            m = build(MODEL, **kw)
        finally:
            vit.BACKBONE_CONFIGS[backbone_name] = saved_cfg
        check(getattr(m, "model", m).backbone.cfg.attention_impl == impl,
              f"the model does not use attention_impl={impl!r}")
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

    stamp("phase 4")
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

    stamp("phase 5")
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

    stamp("phase 6")
    # phase 6b: the training runtime; 6c: the same with loader workers; 4b:
    # serving the student it trained; 4c: exporting it
    tmp = tempfile.mkdtemp(prefix="theia_runtime_")
    try:
        runtime_counts, resumed = training_runtime(card, tmp, teachers, reset_counts, read_counts,
                                                   expected_launches(RUNTIME_STEPS, forward_only(0)))
        torch.cuda.empty_cache()
        stamp("phase 6b")
        worker_loading(card, tmp, reset_counts, read_counts, expected_launches(LOADER_STEPS, forward_only(0)))
        torch.cuda.empty_cache()
        stamp("phase 6c")
        loaded = serve_trained(card, tmp, resumed["ckpt_dir"], attention_model, reset_attention_counts,
                               attention_counts, forward_only)
        stamp("phase 4b")
        export_trained(card, tmp, loaded, model, reset_attention_counts, attention_counts, forward_only)
        del loaded
        torch.cuda.empty_cache()
        stamp("phase 4c")
        # phase 9: the other translators, trained on phase 6b's shards
        conv_ln_rows = translators_phase(card, tmp, teachers, reset_counts, read_counts, ln_pallas)
        stamp("phase 9")
        # phase 11: data parallelism, the CLI under torchrun on phase 6b's shards and two ranks on the card
        data_parallel_phase(card, tmp, teachers)
        torch.cuda.empty_cache()
        stamp("phase 11")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # phase 8: the teachers and offline extraction
    tmp = tempfile.mkdtemp(prefix="theia_extract_")
    try:
        teacher_run = teachers_and_extraction(card, tmp, teachers, attention, reset_attention_counts,
                                              attention_counts, forward_only)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    stamp("phase 8")

    # phase 10: decoding a student's predictions
    decoding_phase(card)
    torch.cuda.empty_cache()
    stamp("phase 10")
    # phase 12: the downstream modules
    downstream_phase(card, model, reset_counts, read_counts)
    torch.cuda.empty_cache()
    stamp("phase 12")
    # phase 13: tensor parallelism, two ranks of one model group on the card
    tp_ln_rows = tensor_parallel_phase(card, teachers, ln_pallas)["ln_rows"]
    torch.cuda.empty_cache()
    stamp("phase 13")

    # phase 7: timings
    print(f"phase 7: timings on {card}:")
    x1 = torch.from_numpy(requests[0]).cuda()
    p50, lo, hi = latency_b1(model.forward_feature, x1)
    print(f"  forward_feature B=1 latency p50 {p50:.3f} ms (min {lo:.3f}, max {hi:.3f}, 50 calls, CUDA events around "
          "each synchronous call, so the host's kernel launches are included)")
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
    # K7 at ViT-H's [8, 257, 16, 80] (phase 8's path, float32; bf16 for the log)
    vit_h_records = {}
    for dtype in (torch.float32, bf16):
        b, t, h, hd = TEACHER_BATCH, 257, 16, 80
        qkv = torch.randn(b, t, 3 * h * hd, device="cuda", generator=gen).to(dtype)
        q, k, v = (y.view(b, t, h, hd) for y in qkv.split(h * hd, dim=-1))
        flops = 4 * b * h * t * t * hd
        res = kernel_row("K7 flash_fwd (ViT-H)", {
            "plain": lambda: attention.flash_fwd_plain(q, k, v), "kernel": lambda: attention.flash_fwd(q, k, v),
            "library": sdpa_forward(q, k, v)}, 4 * q.numel() * q.element_size() + b * h * t * 4, flops, dtype,
            f"[{b},{t},{h},{hd}]")
        vit_h_records[dtype] = res
        if dtype == torch.float32:
            tf32_row("flash_fwd_vit_h", "K7", res, flops, f"[{b},{t},{h},{hd}]",
                     teacher_run["errors"][("flash_fwd", dtype)])
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
            # K3/K4 at the conv translator's LayerNormSpatial shapes (phase 9),
            # the policy heads' (phase 3) and a tensor-parallel rank's split ones (phase 13)
            **({"conv_translator": [v for k, v in conv_ln_rows.items() if k[0] == name],
                "policy_heads": [v for k, v in policy_ln_rows.items() if k[0] == name],
                "tensor_parallel": [v for k, v in tp_ln_rows.items() if k[0] == name]}
               if name in ("ln_bwd_stats", "ln_bwd_dx") else {}),
        })
    # K7 on phase 8's path: ViT-H's 32 layers a call, float32
    (t, bound, by), tb = vit_h_records[torch.float32], vit_h_records[bf16]
    rows.append({
        "name": "flash_fwd_vit_h", "route": "cuda", "source": "theia_tpu_torch/csrc/flash_attn.cu",
        "replaces": f"{FLASH_LIBRARY}:331", "launches": teacher_run["launches"]["flash_fwd"],
        "max_abs_err": teacher_run["errors"][("flash_fwd", torch.float32)], "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": bound, "bound_by": by, "library_ms": t.get("library"),
        "shape": [TEACHER_BATCH, 257, 16, 80], "dtype": "float32",
        "tf32x3_bound_ms": f32_records["flash_fwd_vit_h"]["tf32x3_bound_ms"],
        "bfloat16": {"ms": tb[0]["kernel"], "plain_ms": tb[0]["plain"], "library_ms": tb[0].get("library"),
                     "max_abs_err": teacher_run["errors"][("flash_fwd", bf16)], "bound_ms": tb[1], "bound_by": tb[2]},
    })
    stamp("phase 7")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
