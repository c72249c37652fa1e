"""ViT/DeiT student backbone (cls / nocls / reg variants) in PyTorch.

Port of theia_tpu/models/vit.py:36-67,103-148,169-552: uint8 preprocessing
on the device, the patch embed, pre-LN blocks (eps 1e-12) with packed QKV,
final LayerNorm. Two paths through a block:
  - exact (``fast_math`` off): attention through
    ``ops.attention.packed_attention`` with ``cfg.attention_impl`` (the
    differentiable K1/K2 pair for "pallas" up to 256 tokens, the flash
    kernels K7/K9/K8 for "flash" and for "pallas" past 256 tokens, e.g.
    448² images with ``interpolate_pos_encoding``), exact-erf GELU;
  - ``fast_math``: the JAX ``ATTN_LAYOUT="bhqd_fused"`` branch, in plain
    PyTorch as XLA computed it outside any Pallas kernel: scores q·kᵀ and
    ``softmax(scores / sqrt(hd))`` in the compute dtype, the context kept
    [B, H, T, hd] and contracted over (h, d) in the output projection, tanh
    GELU. K1 and K2 do not run there.
``fuse_preprocessing`` folds resize, crop, rescale, normalise and the patch
embed into one strided convolution on the uint8 pixels (``_fused_embed``),
skipping the PIL inter-pass uint8 rounding, for 224² inputs with every
preprocessing step on, as the JAX module does.

Mixed precision as in the JAX modules: ``dtype`` is the compute dtype; the
parameters keep the dtype they are stored in (float32 for training) and are
cast to ``dtype`` at use, gradients flowing back through the cast. The JAX
package keeps three things in float32 whatever ``dtype`` is, and so does the
port: the patch-embed matmul and its bias (``preferred_element_type``), the
LayerNorms (flax computes stats, normalise and affine in float32 with the
float32 params, then casts), and, on the exact path, the attention scores
and softmax.

Tensor parallelism (``parallel/tp.py``): a block that ``shard_module`` gave
a grid (``tp``) holds ``num_heads / n_model`` heads of q, k and v and that
slice of the MLP's features; its LayerNorm outputs enter the split matmuls
through ``copy_to_model``, and the attention output and the MLP output
projections sum their partial products over the model group before their
biases. Attention runs on the rank's heads as it runs on all of them.

Parameter names follow HF ``ViTModel`` under ``model.`` (``model.embeddings.*``,
``model.encoder.layer.{i}.attention.attention.query`` ...), which is the
reference ``RobotVisionFM`` layout that ``state_dict_from_jax`` emits.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.ops.attention import packed_attention
from theia_tpu_torch.ops.image import _cubic_kernel, bicubic_resize, preprocess_images
from theia_tpu_torch.parallel.tp import copy_to_model, row_parallel_out


@functools.lru_cache(maxsize=8)
def _fused_resize_patch_matrix(
    in_size: int = 224, resize_size: int = 256, crop_size: int = 224, patch: int = 16,
    a: float = -0.5,
) -> tuple[np.ndarray, int, int]:
    """Per-patch 1D resampling weights composing resize+crop+patchify (a
    copy of the JAX package's, checked equal by the tests).

    The DeiT preprocessing (resize 224->256 bicubic, center-crop 224) and the
    16x16 patch split compose into a strided convolution because the input
    stride per patch is exact: patch * in/resize = 16 * 224/256 = 14.0, so
    every patch sees identical fractional tap offsets.

    Returns (A [patch, K], window_start, K): output-pixel py of any patch
    draws input pixels window_start + 14*i + d with weight A[py, d]
    (tap indices may run past the image; border clamping == edge padding).
    """
    scale = in_size / resize_size
    if abs(patch * scale - round(patch * scale)) > 1e-9:
        raise ValueError("fused preprocessing requires integer input stride per patch")
    crop0 = (resize_size - crop_size) // 2
    # source positions for the first patch's output pixels
    src = (np.arange(patch) + crop0 + 0.5) * scale - 0.5
    lo = int(np.floor(src.min() - 2))
    hi = int(np.ceil(src.max() + 2))
    k = hi - lo + 1
    A = np.zeros((patch, k), np.float64)
    for py in range(patch):
        taps = lo + np.arange(k)
        w = _cubic_kernel(src[py] - taps, a)
        s = w.sum()
        A[py] = w / s if s != 0 else w
    return A.astype(np.float32), lo, k


@functools.lru_cache(maxsize=16)
def _fused_constants(cfg: "ViTBackboneConfig", device: torch.device) -> tuple[torch.Tensor, ...]:
    """``_fused_embed``'s float32 constants on ``device``, copied there once
    (no host-to-device copy a step): the resampling weights A [patch, K],
    the per-channel scale 1/(255·std) on raw uint8 and shift −mean/std.
    Made outside inference mode, so that a training step may save them for
    autograd after a call under ``torch.inference_mode()`` cached them."""
    a, _, _ = _fused_resize_patch_matrix(cfg.image_size, cfg.resize_size, cfg.crop_size, cfg.patch_size)
    with torch.inference_mode(False):
        mean = torch.tensor(cfg.image_mean, dtype=torch.float32)
        std = torch.tensor(cfg.image_std, dtype=torch.float32)
        return tuple(c.to(device) for c in (torch.from_numpy(a), 1.0 / (255.0 * std), -mean / std))


@dataclasses.dataclass(frozen=True)
class ViTBackboneConfig:
    """Static config of a ViT/DeiT-style encoder (matches HF ViTConfig fields)."""

    hidden_size: int = 384
    num_layers: int = 12
    num_heads: int = 6
    intermediate_size: int = 1536
    patch_size: int = 16
    image_size: int = 224
    layer_norm_eps: float = 1e-12
    initializer_range: float = 0.02
    qkv_bias: bool = True
    # preprocessing (DeiT AutoProcessor defaults)
    resize_size: int = 256
    crop_size: int = 224
    image_mean: tuple[float, float, float] = (0.5, 0.5, 0.5)
    image_std: tuple[float, float, float] = (0.5, 0.5, 0.5)
    # "pallas": the hand-written CUDA kernels K1/K2 (the flash kernels past
    # 256 tokens); "flash": the tiled flash kernels K7/K9/K8 at any token
    # count; both plain PyTorch on CPU tensors. "einsum": plain PyTorch
    # everywhere. The JAX package defaults to "einsum"; the port's main path
    # runs the kernels.
    attention_impl: str = "pallas"
    fast_math: bool = False

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def spatial(self) -> int:
        return self.image_size // self.patch_size


_DEIT_SIZES = {
    "deit-tiny-patch16-224": dict(hidden_size=192, num_heads=3, intermediate_size=768),
    "deit-small-patch16-224": dict(hidden_size=384, num_heads=6, intermediate_size=1536),
    "deit-base-patch16-224": dict(hidden_size=768, num_heads=12, intermediate_size=3072),
}

BACKBONE_CONFIGS: dict[str, ViTBackboneConfig] = {}
for _sz, _kw in _DEIT_SIZES.items():
    for _prefix in ("", "nocls-", "reg-"):
        BACKBONE_CONFIGS[f"{_prefix}facebook/{_sz}"] = ViTBackboneConfig(**_kw)


def layer_norm(x: torch.Tensor, ln: nn.LayerNorm, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm(dtype=dtype, param_dtype=float32)``: stats,
    normalise and affine in float32 with the params as stored, output in
    ``dtype``. With params stored in ``dtype`` already (bf16 serving) it is
    torch's fused LayerNorm, which computes in float32 inside."""
    if ln.weight.dtype == x.dtype == dtype:
        return F.layer_norm(x, ln.normalized_shape, ln.weight, ln.bias, ln.eps)
    y = F.layer_norm(x.float(), ln.normalized_shape, ln.weight.float(), ln.bias.float(), ln.eps)
    return y.to(dtype)


class _TransformerBlock(nn.Module):
    """Pre-LN ViT encoder block with HF ViTLayer numerics and names; ``tp``:
    the grid of a block cut by ``parallel.tp.shard_module``."""

    tp = None

    def __init__(self, cfg: ViTBackboneConfig, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c = cfg.hidden_size
        self.cfg = cfg
        self.dtype = dtype
        self.layernorm_before = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attention = nn.ModuleDict({
            "attention": nn.ModuleDict(
                {n: nn.Linear(c, c, bias=cfg.qkv_bias) for n in ("query", "key", "value")}
            ),
            "output": nn.ModuleDict({"dense": nn.Linear(c, c)}),
        })
        self.layernorm_after = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.intermediate = nn.ModuleDict({"dense": nn.Linear(c, cfg.intermediate_size)})
        self.output = nn.ModuleDict({"dense": nn.Linear(cfg.intermediate_size, c)})

    def _dense(self, m: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        return F.linear(x, m.weight.to(dt), m.bias.to(dt))

    def _row(self, m: nn.Linear, product) -> torch.Tensor:
        """A row-parallel projection: ``product(weight, bias)``; where the
        block is cut, the product without its bias, summed over the model
        group, then the bias."""
        dt = self.dtype
        if self.tp is None:
            return product(m.weight.to(dt), m.bias.to(dt))
        return row_parallel_out(product(m.weight.to(dt), None), m.bias, self.tp, dt)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        dt = self.dtype
        heads = cfg.num_heads if self.tp is None else cfg.num_heads // self.tp.n_model
        h = self._split_input(layer_norm(x, self.layernorm_before, dt))
        # packed QKV: one matmul over the concatenated column blocks
        qkv_layers = [self.attention["attention"][n] for n in ("query", "key", "value")]
        w_qkv = torch.cat([m.weight for m in qkv_layers]).to(dt)
        b_qkv = torch.cat([m.bias for m in qkv_layers]).to(dt) if cfg.qkv_bias else None
        qkv = F.linear(h, w_qkv, b_qkv)
        if cfg.fast_math:
            product = self._fast_attention(qkv, heads)
        else:
            # the kernels read q, k, v in place in the packed projection
            ctx = packed_attention(qkv, heads, implementation=cfg.attention_impl)
            product = functools.partial(F.linear, ctx)
        x = x + self._row(self.attention["output"]["dense"], product)
        h = self._split_input(layer_norm(x, self.layernorm_after, dt))
        # exact erf GELU, or JAX's gelu(approximate=True) under fast_math
        h = F.gelu(self._dense(self.intermediate["dense"], h), approximate="tanh" if cfg.fast_math else "none")
        return x + self._row(self.output["dense"], functools.partial(F.linear, h))

    def _split_input(self, h: torch.Tensor) -> torch.Tensor:
        """The input of the column-parallel matmuls: through
        ``copy_to_model`` where the block is cut."""
        return h if self.tp is None else copy_to_model(h, self.tp)

    def _fast_attention(self, qkv: torch.Tensor, heads: int):
        """The JAX fast_math "bhqd_fused" attention over a packed QKV
        projection [B, T, 3C] of ``heads`` heads, every product and the
        softmax in the compute dtype; returns the output projection as a
        function of its weight [C_out, C] and bias (or None)."""
        b, t, c3 = qkv.shape
        c = c3 // 3
        hd = c // heads
        q, k, v = (y.view(b, t, heads, hd).transpose(1, 2) for y in qkv.split(c, dim=-1))  # [B, H, T, hd]
        probs = torch.softmax(torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
        ctx = torch.matmul(probs, v)  # [B, H, T, hd]: the layout JAX contracts in the projection

        def project(w: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
            y = torch.einsum("bhqd,chd->bqc", ctx, w.view(w.shape[0], heads, hd))
            return y if bias is None else y + bias

        return project


class _Embeddings(nn.Module):
    """Patch projection, position embeddings and the CLS / register tokens."""

    def __init__(self, cfg: ViTBackboneConfig, variant: str, num_reg_tokens: int) -> None:
        super().__init__()
        c = cfg.hidden_size
        p = cfg.patch_size
        self.patch_embeddings = nn.ModuleDict({"projection": nn.Conv2d(3, c, p, stride=p)})
        # stored (1, 1+N, C) for every variant, as the reference weights are
        self.position_embeddings = nn.Parameter(torch.empty(1, 1 + cfg.num_patches, c))
        if variant != "nocls":
            self.cls_token = nn.Parameter(torch.empty(1, 1, c))
        if variant == "reg":
            self.reg_token = nn.Parameter(torch.empty(1, num_reg_tokens, c))
            self.reg_pos_embed = nn.Parameter(torch.empty(1, num_reg_tokens, c))


class _ViTModel(nn.Module):
    def __init__(self, cfg: ViTBackboneConfig, variant: str, num_reg_tokens: int, dtype: torch.dtype) -> None:
        super().__init__()
        self.embeddings = _Embeddings(cfg, variant, num_reg_tokens)
        self.encoder = nn.ModuleDict(
            {"layer": nn.ModuleList(_TransformerBlock(cfg, dtype) for _ in range(cfg.num_layers))}
        )
        self.layernorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class ViTBackbone(nn.Module):
    """ViT/DeiT student backbone.

    variant:
      - "cls": standard DeiT; output tokens [B, 1+N, C];
      - "nocls": no CLS token; only position_embeddings[:, 1:] is added;
        output [B, N, C];
      - "reg": CLS + patches + ``num_reg_tokens`` trailing register tokens
        with their own position embedding; output [B, 1+N+R, C].

    ``dtype`` is the compute dtype (the output's dtype).
    ``fuse_preprocessing``: the one-convolution embed (``_fused_embed``)
    where it applies, as in the JAX module.
    """

    def __init__(self, cfg: ViTBackboneConfig, variant: str = "cls", num_reg_tokens: int = 0,
                 dtype: torch.dtype = torch.float32, fuse_preprocessing: bool = False) -> None:
        super().__init__()
        if variant not in ("cls", "nocls", "reg"):
            raise ValueError(f"unknown variant {variant}")
        if variant == "reg" and num_reg_tokens <= 0:
            raise ValueError("reg variant requires num_reg_tokens > 0")
        self.cfg = cfg
        self.variant = variant
        self.dtype = dtype
        self.fuse_preprocessing = fuse_preprocessing
        self.num_reg_tokens = num_reg_tokens if variant == "reg" else 0
        self.model = _ViTModel(cfg, variant, self.num_reg_tokens, dtype)

    @property
    def no_cls(self) -> bool:
        return self.variant == "nocls"

    def get_feature_size(self, keep_spatial: bool = False) -> tuple[int, ...]:
        cfg = self.cfg
        if keep_spatial:
            return (cfg.hidden_size, cfg.spatial, cfg.spatial)
        return (cfg.hidden_size, cfg.num_patches)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """HF ViT init: trunc_normal(initializer_range) weights and embeddings,
        zero biases, LayerNorm ones/zeros. Walks parameters in a fixed order."""
        for name, p in self.model.named_parameters():
            if "layernorm" in name:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                nn.init.trunc_normal_(p, std=self.cfg.initializer_range, generator=generator)

    def _patch_embed(self, x: torch.Tensor) -> torch.Tensor:
        """[B,H,W,3] in the compute dtype -> [B,N,C] as extract-patches + one
        float32 matmul over the kernel cast to the compute dtype, plus the
        float32 bias, then cast (the JAX formulation; cuBLAS runs it faster
        than cuDNN's non-TF32 conv)."""
        proj = self.model.embeddings.patch_embeddings["projection"]
        p = self.cfg.patch_size
        b, h, w, _ = x.shape
        nh, nw = h // p, w // p
        patches = x.permute(0, 3, 1, 2)[..., : nh * p, : nw * p].reshape(b, 3, nh, p, nw, p)
        patches = patches.permute(0, 2, 4, 1, 3, 5).reshape(b, nh * nw, 3 * p * p)  # (c, kh, kw) order
        weight = proj.weight.to(self.dtype).float().reshape(proj.out_channels, -1)
        y = F.linear(patches.float(), weight, proj.bias.float())
        return y.to(self.dtype)

    def _fused_embed(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 [B,H,W,3] or [B,3,H,W] -> [B,N,C] via one composite strided
        convolution (the JAX ``_fused_embed``).

        The composite kernel contracts the per-patch resize weights A with
        the patch kernel, scaled per input channel by 1/(255·std); the
        normalisation shift folds into the bias. Both are computed in
        float32 from the params, and the kernel is cast to the compute
        dtype. Edge padding reproduces the resize's border clamping; the
        uint8 pixels are exact in bf16. The convolution is cuDNN's on CUDA
        (XLA's in JAX); float32 parity needs ``torch.backends.cudnn.allow_tf32
        = False``."""
        cfg = self.cfg
        if not (x.shape[1] == 3 and x.shape[-1] != 3):
            x = x.permute(0, 3, 1, 2)  # channels-last input
        b = x.shape[0]
        p = cfg.patch_size
        _, lo, k = _fused_resize_patch_matrix(cfg.image_size, cfg.resize_size, cfg.crop_size, p)
        a, s, t = _fused_constants(cfg, x.device)
        stride = p * cfg.image_size // cfg.resize_size
        n = cfg.spatial

        proj = self.model.embeddings.patch_embeddings["projection"]
        w = proj.weight.float()  # [C, 3, p, p]: JAX's patch_kernel is the same numbers in (kh, kw, cin) order
        wc = torch.einsum("pk,qm,dcpq->dckm", a, a, w * s[None, :, None, None])  # [C, 3, K, K]
        bc = proj.bias.float() + torch.einsum("c,dcpq->d", t, w)

        pad_hi = max(lo + stride * (n - 1) + (k - 1) - (cfg.image_size - 1), 0)
        xf = x.to(self.dtype)
        if pad_hi:
            xf = F.pad(xf, (0, pad_hi, 0, pad_hi), mode="replicate")
        y = F.conv2d(xf[:, :, lo:, lo:], wc.to(self.dtype), stride=stride)
        y = y + bc.to(self.dtype)[:, None, None]
        return y.reshape(b, cfg.hidden_size, n * n).transpose(1, 2)

    def _interp_patch_pos(self, nh: int, nw: int) -> torch.Tensor:
        """Bicubic pos-embed interpolation with the reference's h0+0.1 quirk:
        torch bicubic (a=-0.75), scale=(h0+0.1)/sqrt(N)."""
        cfg = self.cfg
        s = int(math.sqrt(cfg.num_patches))
        pos = self.model.embeddings.position_embeddings
        patch_pos = pos[:, 1:].reshape(1, s, s, cfg.hidden_size).float()
        out = bicubic_resize(
            patch_pos, nh, nw, a=-0.75, antialias=False,
            scale_h=(nh + 0.1) / s, scale_w=(nw + 0.1) / s,
        )
        return out.reshape(1, nh * nw, cfg.hidden_size)

    def forward(
        self,
        x: torch.Tensor,
        do_resize: bool = True,
        interpolate_pos_encoding: Optional[bool] = None,
        do_rescale: bool = True,
        do_normalize: bool = True,
    ) -> torch.Tensor:
        """uint8 [B,H,W,C] or [B,C,H,W] images -> last hidden state tokens."""
        cfg = self.cfg
        emb = self.model.embeddings
        dtype = self.dtype
        spatial_ok = x.dim() == 4 and (
            (x.shape[1] == cfg.image_size and x.shape[2] == cfg.image_size)
            or (x.shape[2] == cfg.image_size and x.shape[3] == cfg.image_size)
        )
        if self.fuse_preprocessing and do_resize and do_rescale and do_normalize and spatial_ok:
            tokens = self._fused_embed(x)
            b = tokens.shape[0]
            nh = nw = cfg.spatial
        else:
            x = preprocess_images(
                x,
                do_resize=do_resize,
                do_rescale=do_rescale,
                do_normalize=do_normalize,
                resize_size=cfg.resize_size,
                crop_size=cfg.crop_size,
                image_mean=cfg.image_mean,
                image_std=cfg.image_std,
                out_dtype=dtype,
            )
            b, h, w, _ = x.shape
            nh, nw = h // cfg.patch_size, w // cfg.patch_size
            tokens = self._patch_embed(x)

        interp = bool(interpolate_pos_encoding) and (nh * nw != cfg.num_patches or nh != nw)
        pos = emb.position_embeddings
        patch_pos = self._interp_patch_pos(nh, nw) if interp else pos[:, 1:]

        if self.variant == "nocls":
            tokens = tokens + patch_pos.to(dtype)
        else:
            parts = [emb.cls_token.to(dtype).expand(b, -1, -1), tokens]
            pos_parts = [pos[:, :1], patch_pos]
            if self.variant == "reg":
                parts.append(emb.reg_token.to(dtype).expand(b, -1, -1))
                pos_parts.append(emb.reg_pos_embed)
            tokens = torch.cat(parts, dim=1) + torch.cat(pos_parts, dim=1).to(dtype)

        for block in self.model.encoder["layer"]:
            tokens = block(tokens)
        return layer_norm(tokens, self.model.layernorm, dtype)


def build_backbone(
    model_name: str,
    image_size: int = 224,
    num_reg_tokens: int = 7,
    fast_math: bool = False,
    dtype: torch.dtype = torch.float32,
    fuse_preprocessing: bool = False,
) -> ViTBackbone:
    """Backbone factory dispatching on "reg"/"nocls"/"deit" substrings."""
    if model_name not in BACKBONE_CONFIGS:
        raise NotImplementedError(f"Requested {model_name} is not implemented.")
    cfg = dataclasses.replace(BACKBONE_CONFIGS[model_name], image_size=image_size, fast_math=fast_math)
    common = dict(dtype=dtype, fuse_preprocessing=fuse_preprocessing)
    if "reg" in model_name:
        return ViTBackbone(cfg, variant="reg", num_reg_tokens=num_reg_tokens, **common)
    if "nocls" in model_name:
        return ViTBackbone(cfg, variant="nocls", **common)
    return ViTBackbone(cfg, variant="cls", **common)
