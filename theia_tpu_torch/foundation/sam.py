"""SAM ViT-H vision encoder (port of theia_tpu/foundation/sam.py:26-183,
222-234; reference: src/theia/foundation_models/vision_models/sam.py:247-393
uses the HF SamModel vision tower to produce (B, 256, 64, 64) embeddings).

16x16 patch embed on 1024x1024 input -> 64x64 token map, windowed
attention (14x14 windows, the grid padded to 70x70; global layers at
{7,15,23,31} for ViT-H) with decomposed relative position bias, and a
bias-free conv neck to 256 channels. Parameter names are HF
``SamVisionEncoder``'s, so its state dict (or a ``SamModel``'s, whose
``vision_encoder.`` prefix is stripped) loads with ``strict=True``.

The attention stays plain PyTorch: the decomposed rel-pos bias fits no
kernel of the port. Its float32 scores are computed in blocks of query rows
(``SCORE_BLOCK_BYTES`` a block): a global layer's whole score tensor is
[B·16, 4096, 4096], 1 GiB an image, which at the extraction's default batch
of 32 would not fit the card. Rows are independent, so the function is the
same.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.foundation.towers import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    ChannelLayerNorm,
    channels_last,
    dense,
    init_weights_,
    patchify,
    strip_prefix,
)
from theia_tpu_torch.models.vit import layer_norm
from theia_tpu_torch.ops.image import preprocess_images

# float32 scores of one block of query rows, in bytes (a block's softmax
# output doubles it)
SCORE_BLOCK_BYTES = 1 << 30


@dataclasses.dataclass(frozen=True)
class SamVisionConfig:
    hidden_size: int = 1280
    num_layers: int = 32
    num_heads: int = 16
    mlp_dim: int = 5120
    image_size: int = 1024
    patch_size: int = 16
    window_size: int = 14
    global_attn_indexes: tuple[int, ...] = (7, 15, 23, 31)
    output_channels: int = 256
    layer_norm_eps: float = 1e-6

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


SAM_VIT_HUGE = SamVisionConfig()


def _rel_index(size: int) -> np.ndarray:
    """Static gather indices into a (2*size-1, hd) rel-pos table:
    idx[i, j] = i - j + size - 1 (q_size == k_size path of HF get_rel_pos)."""
    i = np.arange(size)[:, None]
    j = np.arange(size)[None, :]
    return (i - j + size - 1).astype(np.int32)


def _decomposed_attn(q, k, v, rel_pos_h, rel_pos_w, num_heads: int, h: int, w: int, dtype: torch.dtype,
                     block_bytes: int = SCORE_BLOCK_BYTES) -> torch.Tensor:
    """Attention with decomposed relative position bias (HF SamVisionAttention).

    q/k/v: [B', HW, C] where B' includes windows; h, w are the spatial dims.
    Scores, the bias terms and the softmax in float32, probabilities cast to
    ``dtype``, as the JAX function; query rows in blocks of at most
    ``block_bytes`` of scores.
    """
    bp, hw, c = q.shape
    hd = c // num_heads
    scale = hd ** -0.5
    qh, kh, vh = (y.reshape(bp, hw, num_heads, hd).transpose(1, 2) for y in (q, k, v))  # [B', n, HW, hd]
    idx_h = torch.from_numpy(_rel_index(h).astype(np.int64)).to(q.device)
    idx_w = torch.from_numpy(_rel_index(w).astype(np.int64)).to(q.device)
    rh = rel_pos_h[idx_h].to(dtype).float()  # (h, h, hd)
    rw = rel_pos_w[idx_w].to(dtype).float()  # (w, w, hd)
    qs = qh.float().reshape(bp, num_heads, h, w, hd)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", qs, rh).reshape(bp, num_heads, hw, h)
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", qs, rw).reshape(bp, num_heads, hw, w)
    q_scaled = (qh * scale).float()
    k_t = kh.float().transpose(-1, -2)
    rows = max(1, min(hw, block_bytes // (bp * num_heads * hw * 4)))
    out = torch.empty(bp, num_heads, hw, hd, dtype=v.dtype, device=v.device)
    for r0 in range(0, hw, rows):
        r1 = min(hw, r0 + rows)
        s = torch.matmul(q_scaled[:, :, r0:r1], k_t).view(bp, num_heads, r1 - r0, h, w)
        s.add_(rel_h[:, :, r0:r1, :, None]).add_(rel_w[:, :, r0:r1, None, :])
        probs = torch.softmax(s.view(bp, num_heads, r1 - r0, hw), dim=-1).to(dtype)
        out[:, :, r0:r1] = torch.matmul(probs, vh)
    return out.transpose(1, 2).reshape(bp, hw, c)


class _SamLayer(nn.Module):
    def __init__(self, cfg: SamVisionConfig, size: int) -> None:
        super().__init__()
        c = cfg.hidden_size
        hd = c // cfg.num_heads
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attn = nn.Module()
        self.attn.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.attn.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.attn.qkv = nn.Linear(c, 3 * c)
        self.attn.proj = nn.Linear(c, c)
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"lin1": nn.Linear(c, cfg.mlp_dim), "lin2": nn.Linear(cfg.mlp_dim, c)})


class SamVisionEncoder(nn.Module):
    """Returns the neck output as NHWC [B, 64, 64, 256]."""

    def __init__(self, cfg: SamVisionConfig = SAM_VIT_HUGE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c, g, p = cfg.hidden_size, cfg.grid, cfg.patch_size
        oc = cfg.output_channels
        self.cfg = cfg
        self.dtype = dtype
        self.pos_embed = nn.Parameter(torch.zeros(1, g, g, c))
        self.patch_embed = nn.ModuleDict({"projection": nn.Conv2d(3, c, p, stride=p)})
        self.layers = nn.ModuleList(
            _SamLayer(cfg, g if i in cfg.global_attn_indexes else cfg.window_size) for i in range(cfg.num_layers)
        )
        self.neck = nn.Module()
        self.neck.conv1 = nn.Conv2d(c, oc, 1, bias=False)
        self.neck.layer_norm1 = ChannelLayerNorm(oc)
        self.neck.conv2 = nn.Conv2d(oc, oc, 3, padding=1, bias=False)
        self.neck.layer_norm2 = ChannelLayerNorm(oc)

    def forward(self, images: torch.Tensor, do_preprocess: bool = True) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        c, g, win = cfg.hidden_size, cfg.grid, cfg.window_size
        if do_preprocess:
            # SamImageProcessor: longest edge -> 1024 (bilinear), rescale,
            # ImageNet normalize, pad to square (square inputs: plain resize)
            x = preprocess_images(
                images, resize_size=cfg.image_size, crop_size=cfg.image_size, image_mean=IMAGENET_MEAN,
                image_std=IMAGENET_STD, out_dtype=dt, resample="linear",
            )
        else:
            x = channels_last(images, dt)
        b = x.shape[0]
        proj = self.patch_embed["projection"]
        x = patchify(x, proj.weight, proj.bias, dt).reshape(b, g, g, c) + self.pos_embed.to(dt)

        pad = (win - g % win) % win
        gp = g + pad
        nwin = gp // win
        for i, layer in enumerate(self.layers):
            is_global = i in cfg.global_attn_indexes
            size = g if is_global else win
            h1 = layer_norm(x, layer.layer_norm1, dt)
            if not is_global:
                h1 = F.pad(h1, (0, 0, 0, pad, 0, pad))
                h1 = h1.reshape(b, nwin, win, nwin, win, c).transpose(2, 3).reshape(b * nwin * nwin, win * win, c)
            else:
                h1 = h1.reshape(b, g * g, c)
            q, k, v = dense(layer.attn.qkv, h1, dt).split(c, dim=-1)
            a = _decomposed_attn(q, k, v, layer.attn.rel_pos_h, layer.attn.rel_pos_w, cfg.num_heads, size, size, dt)
            a = dense(layer.attn.proj, a, dt)
            if not is_global:
                a = a.reshape(b, nwin, nwin, win, win, c).transpose(2, 3).reshape(b, gp, gp, c)[:, :g, :g]
            else:
                a = a.reshape(b, g, g, c)
            x = x + a
            h2 = F.gelu(dense(layer.mlp["lin1"], layer_norm(x, layer.layer_norm2, dt), dt), approximate="none")
            x = x + dense(layer.mlp["lin2"], h2, dt)

        # neck: 1x1 conv -> LN2d -> 3x3 conv -> LN2d (all convs biasless)
        neck = self.neck
        x = F.linear(x, neck.conv1.weight[:, :, 0, 0].to(dt))
        x = neck.layer_norm1(x)
        x = F.conv2d(x.permute(0, 3, 1, 2), neck.conv2.weight.to(dt), padding=1).permute(0, 2, 3, 1)
        return neck.layer_norm2(x)


def get_sam_model(
    model_name: str = "facebook/sam-vit-huge",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
    cfg: SamVisionConfig = SAM_VIT_HUGE,
) -> SamVisionEncoder:
    """The vision encoder on ``device`` — vision-feature path
    (with_upscaled=False), matching reference get_sam_model (sam.py:355-375):
    an HF SamModel (``vision_encoder.`` keys) or bare encoder state dict
    loaded strictly, else a seeded random init."""
    with torch.device(device):
        module = SamVisionEncoder(cfg, dtype=dtype)
    if state_dict is not None:
        sd = strip_prefix(state_dict, "vision_encoder.")
        module.load_state_dict({k: torch.as_tensor(v) for k, v in sd.items()}, strict=True)
    else:
        init_weights_(module, generator)
    return module.eval().requires_grad_(False)


def get_sam_feature(module: SamVisionEncoder, images: torch.Tensor):
    """(image_embeddings [B,256,64,64], None) matching reference
    get_sam_feature with with_upscaled=False (sam.py:329-352)."""
    return module(images).permute(0, 3, 1, 2), None
