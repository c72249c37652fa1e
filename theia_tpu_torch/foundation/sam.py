"""SAM ViT-H vision encoder (port of theia_tpu/foundation/sam.py:26-183,
222-234; reference: src/theia/foundation_models/vision_models/sam.py:247-393
uses the HF SamModel vision tower to produce (B, 256, 64, 64) embeddings).

16x16 patch embed on 1024x1024 input -> 64x64 token map, windowed
attention (14x14 windows, the grid padded to 70x70; global layers at
{7,15,23,31} for ViT-H) with decomposed relative position bias, and a
bias-free conv neck to 256 channels. Parameter names are HF
``SamVisionEncoder``'s, so its state dict (or a ``SamModel``'s, whose
``vision_encoder.`` prefix is stripped) loads with ``strict=True``.

The attention of both layer kinds is ``ops/attention.py``
``relpos_attention``, which runs where the tensors are: on float32 CUDA
tensors the hand-written kernel K12 (``csrc/relpos_attn.cu``), which adds
the bias to the scores on chip and writes no score tensor; on the CPU, and
in any other dtype, the plain version ``relpos_attention_plain``, which
writes its float32 scores in blocks of query rows. Each layer's attention
call is a span (``utils/profiling.py``), ``sam.attn.window`` or
``sam.attn.global``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

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
from theia_tpu_torch.ops.attention import relpos_attention
from theia_tpu_torch.ops.image import preprocess_images
from theia_tpu_torch.utils.profiling import span


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


def _conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The neck's 3x3 convolution, NCHW. In float32 cuDNN's TF32, which
    PyTorch allows by default (``torch.backends.cudnn.allow_tf32``), is
    switched off around it, so that a float32 encoder computes in float32 as
    its matmuls do (TF32 matmuls are off by default); TF32 here moved SAM-H's
    float32 embedding by ~3e-4 (rel L2) from the plain float32 reference."""
    if x.dtype != torch.float32 or not torch.backends.cudnn.allow_tf32:
        return F.conv2d(x, weight, padding=1)
    torch.backends.cudnn.allow_tf32 = False
    try:
        return F.conv2d(x, weight, padding=1)
    finally:
        torch.backends.cudnn.allow_tf32 = True


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

    def _attention(self, layer: _SamLayer, x: torch.Tensor, is_global: bool) -> torch.Tensor:
        """A layer's attention branch on [B, g, g, C]: LayerNorm, the window
        partition (the grid zero-padded to whole windows) unless the layer is
        global, the attention, the projection and the unpartition. Each large
        temporary is dropped once used, so that a layer holds at most one of
        the projection's [B', T, 3C] at a time."""
        cfg, dt = self.cfg, self.dtype
        c, g, win = cfg.hidden_size, cfg.grid, cfg.window_size
        b = x.shape[0]
        pad = (win - g % win) % win
        n = (g + pad) // win
        h = layer_norm(x, layer.layer_norm1, dt)
        if is_global:
            size, h = g, h.reshape(b, g * g, c)
        else:
            h = F.pad(h, (0, 0, 0, pad, 0, pad))
            size, h = win, h.reshape(b, n, win, n, win, c).transpose(2, 3).reshape(b * n * n, win * win, c)
        qkv = dense(layer.attn.qkv, h, dt)
        del h
        with span("sam.attn.global" if is_global else "sam.attn.window"):
            a = relpos_attention(qkv, layer.attn.rel_pos_h, layer.attn.rel_pos_w, cfg.num_heads, size)
        del qkv
        a = dense(layer.attn.proj, a, dt)
        if is_global:
            return a.reshape(b, g, g, c)
        return a.reshape(b, n, n, win, win, c).transpose(2, 3).reshape(b, n * win, n * win, c)[:, :g, :g]

    def _mlp(self, layer: _SamLayer, x: torch.Tensor) -> torch.Tensor:
        """A layer's MLP branch: LayerNorm, lin1, exact GELU, lin2."""
        dt = self.dtype
        h = dense(layer.mlp["lin1"], layer_norm(x, layer.layer_norm2, dt), dt)
        h = F.gelu(h, approximate="none")
        return dense(layer.mlp["lin2"], h, dt)

    def forward(self, images: torch.Tensor, do_preprocess: bool = True) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        c, g = cfg.hidden_size, cfg.grid
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
        for i, layer in enumerate(self.layers):
            x = x + self._attention(layer, x, i in cfg.global_attn_indexes)
            x = x + self._mlp(layer, x)

        # neck: 1x1 conv -> LN2d -> 3x3 conv -> LN2d (all convs biasless)
        neck = self.neck
        x = F.linear(x, neck.conv1.weight[:, :, 0, 0].to(dt))
        x = neck.layer_norm1(x)
        x = _conv3x3(x.permute(0, 3, 1, 2), neck.conv2.weight.to(dt)).permute(0, 2, 3, 1)
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
