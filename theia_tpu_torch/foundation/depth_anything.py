"""Depth-Anything teacher: DINOv2 backbone + DPT neck/head (port of
theia_tpu/foundation/depth_anything.py:39-218, 252-275).

Behaviour of the reference's vendored implementation (reference:
src/theia/foundation_models/vision_models/depth_anything.py:143-601):
  - Dinov2Backbone hidden states at 4 stages (shared final-LN applied);
  - reassemble stage (1x1 proj + resize ladder per stage: deconv x4/x2,
    identity, stride-2 conv), 3x3 biasless convs to fusion width;
  - feature-fusion stage (pre-act residual units, bilinear
    align_corners=True upsampling, 1x1 projections);
  - depth head; the stored teacher feature is the head's conv1->
    bilinear-to-input-res -> conv2 output ("head" feature,
    DepthAnythingHeadFeature :551-601), which extraction nearest-resizes to
    (64, 64) (preprocessing/feature_extraction_core/models.py:91-93).

Parameter names are HF ``DepthAnythingForDepthEstimation``'s. The maps run
NCHW through cuDNN's convolutions (the transposed ones too: the JAX
package's ``ops/convt.py`` is a TPU lowering of the same function); the
bilinear resizes are the two-matmul resizes of ``ops/image.py``, as in the
JAX module. NHWC at the public surface, as there.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.foundation.towers import (
    DINOV2_LARGE,
    IMAGENET_MEAN,
    IMAGENET_STD,
    Dinov2Tower,
    TowerConfig,
    channels_last,
    init_weights_,
)
from theia_tpu_torch.ops.image import _resize_matrix_on, _resize_nchw, preprocess_images


@dataclasses.dataclass(frozen=True)
class DepthAnythingConfig:
    backbone: TowerConfig = dataclasses.replace(
        DINOV2_LARGE, image_size=518, resize_size=518, crop_size=518
    )
    # hidden_states indices into [embeddings, layer1..layerN]
    backbone_stage_indices: tuple[int, ...] = (5, 12, 18, 24)
    reassemble_hidden_size: int = 1024
    neck_hidden_sizes: tuple[int, ...] = (256, 512, 1024, 1024)
    reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
    fusion_hidden_size: int = 256
    head_hidden_size: int = 32
    patch_size: int = 14


DEPTH_ANYTHING_LARGE = DepthAnythingConfig()


def _bilinear(x: torch.Tensor, h: int, w: int, align_corners: bool) -> torch.Tensor:
    """NCHW bilinear resize, torch semantics (no antialias) at either corner mode."""
    mh = _resize_matrix_on(x.shape[2], h, -0.5, None, False, x.device, x.dtype, "linear", align_corners)
    mw = _resize_matrix_on(x.shape[3], w, -0.5, None, False, x.device, x.dtype, "linear", align_corners)
    return _resize_nchw(x, mh, mw, pil_uint8_rounding=False)


def _conv(x: torch.Tensor, m: nn.Conv2d, dtype: torch.dtype, stride: int = 1, padding: int = 0) -> torch.Tensor:
    return F.conv2d(x, m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype), stride, padding)


class _Residual(nn.Module):
    def __init__(self, f: int) -> None:
        super().__init__()
        self.convolution1 = nn.Conv2d(f, f, 3, padding=1)
        self.convolution2 = nn.Conv2d(f, f, 3, padding=1)

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        h = _conv(F.relu(x), self.convolution1, dtype, padding=1)
        return _conv(F.relu(h), self.convolution2, dtype, padding=1) + x


class DepthAnything(nn.Module):
    """``forward`` returns predicted depth [B,H,W]; ``head_feature`` the head
    feature NHWC [B,H,W,head_hidden]."""

    def __init__(self, cfg: DepthAnythingConfig = DEPTH_ANYTHING_LARGE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        self.cfg = cfg
        self.dtype = dtype
        f = cfg.fusion_hidden_size
        self.backbone = Dinov2Tower(cfg.backbone, dtype=dtype)
        reassemble = nn.ModuleList()
        for ch, factor in zip(cfg.neck_hidden_sizes, cfg.reassemble_factors):
            layer = nn.Module()
            layer.projection = nn.Conv2d(cfg.reassemble_hidden_size, ch, 1)
            if factor > 1:
                layer.resize = nn.ConvTranspose2d(ch, ch, int(factor), stride=int(factor))
            elif factor < 1:
                layer.resize = nn.Conv2d(ch, ch, 3, stride=int(1 / factor), padding=1)
            reassemble.append(layer)
        fusion = nn.ModuleList()
        for _ in cfg.neck_hidden_sizes:
            layer = nn.Module()
            layer.projection = nn.Conv2d(f, f, 1)
            layer.residual_layer1 = _Residual(f)
            layer.residual_layer2 = _Residual(f)
            fusion.append(layer)
        self.neck = nn.Module()
        self.neck.reassemble_stage = nn.ModuleDict({"layers": reassemble})
        self.neck.convs = nn.ModuleList(nn.Conv2d(ch, f, 3, padding=1, bias=False) for ch in cfg.neck_hidden_sizes)
        self.neck.fusion_stage = nn.ModuleDict({"layers": fusion})
        self.head = nn.Module()
        self.head.conv1 = nn.Conv2d(f, f // 2, 3, padding=1)
        self.head.conv2 = nn.Conv2d(f // 2, cfg.head_hidden_size, 3, padding=1)
        self.head.conv3 = nn.Conv2d(cfg.head_hidden_size, 1, 1)

    def neck_features(self, images: torch.Tensor, do_preprocess: bool = True) -> list[torch.Tensor]:
        """The fusion stage's outputs, NCHW, shallowest last."""
        cfg, dt = self.cfg, self.dtype
        if do_preprocess:
            x = preprocess_images(
                images, resize_size=cfg.backbone.image_size, crop_size=cfg.backbone.image_size,
                image_mean=IMAGENET_MEAN, image_std=IMAGENET_STD, out_dtype=dt,
            )
        else:
            x = channels_last(images, dt)
        ph = pw = cfg.backbone.image_size // cfg.patch_size
        _, _, states = self.backbone(x, do_preprocess=False, output_hidden_indices=cfg.backbone_stage_indices)

        # reassemble: drop cls, to an NCHW map, 1x1 proj, resize ladder
        feats = []
        for i, h in enumerate(states):
            b, _, c = h.shape
            m = h[:, 1:].transpose(1, 2).reshape(b, c, ph, pw)
            layer = self.neck.reassemble_stage["layers"][i]
            m = _conv(m, layer.projection, dt)
            factor = cfg.reassemble_factors[i]
            if factor > 1:
                r = layer.resize
                m = F.conv_transpose2d(m, r.weight.to(dt), r.bias.to(dt), stride=int(factor))
            elif factor < 1:
                m = _conv(m, layer.resize, dt, stride=int(1 / factor), padding=1)
            feats.append(_conv(m, self.neck.convs[i], dt, padding=1))

        # fusion (reference :252-319): start from deepest
        rev = feats[::-1]
        layers = self.neck.fusion_stage["layers"]
        h0 = layers[0].residual_layer2(rev[0], dt)
        h0 = _bilinear(h0, rev[1].shape[2], rev[1].shape[3], align_corners=True)
        fused = _conv(h0, layers[0].projection, dt)
        fused_list = [fused]
        for idx in range(1, len(rev)):
            layer = layers[idx]
            residual = rev[idx]
            if fused.shape != residual.shape:
                residual = _bilinear(residual, fused.shape[2], fused.shape[3], align_corners=False)
            h = fused + layer.residual_layer1(residual, dt)
            h = layer.residual_layer2(h, dt)
            if idx != len(rev) - 1:
                th, tw = rev[idx + 1].shape[2], rev[idx + 1].shape[3]
            else:
                th, tw = h.shape[2] * 2, h.shape[3] * 2
            h = _bilinear(h, th, tw, align_corners=True)
            fused = _conv(h, layer.projection, dt)
            fused_list.append(fused)
        return fused_list

    def _head_feature_nchw(self, images: torch.Tensor, do_preprocess: bool) -> torch.Tensor:
        dt = self.dtype
        h = _conv(self.neck_features(images, do_preprocess=do_preprocess)[-1], self.head.conv1, dt, padding=1)
        size = self.cfg.backbone.image_size
        h = _bilinear(h, size, size, align_corners=True)
        return _conv(h, self.head.conv2, dt, padding=1)

    def head_feature(self, images: torch.Tensor, do_preprocess: bool = True) -> torch.Tensor:
        """DepthAnythingHeadFeature (:551-601): conv1 -> bilinear(ac=True) to
        input res -> conv2. NHWC output [B, H, W, head_hidden]."""
        return self._head_feature_nchw(images, do_preprocess).permute(0, 2, 3, 1)

    def forward(self, images: torch.Tensor, do_preprocess: bool = True) -> torch.Tensor:
        """Full depth estimation (reference :437-507): head feature ->
        relu -> conv3 -> relu -> [B, H, W] depth."""
        h = F.relu(self._head_feature_nchw(images, do_preprocess))
        return F.relu(_conv(h, self.head.conv3, self.dtype))[:, 0]


def get_depth_anything_model(
    model_name: str = "LiheYoung/depth-anything-large-hf",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
    cfg: DepthAnythingConfig = DEPTH_ANYTHING_LARGE,
) -> DepthAnything:
    """The model on ``device``: an HF DepthAnythingForDepthEstimation state
    dict loaded strictly, else a seeded random init."""
    with torch.device(device):
        module = DepthAnything(cfg, dtype=dtype)
    if state_dict is not None:
        module.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    else:
        init_weights_(module, generator)
    return module.eval().requires_grad_(False)


def get_depth_anything_feature(module: DepthAnything, images: torch.Tensor) -> torch.Tensor:
    """Head feature in BCHW (reference feature path); extraction resizes to
    (64, 64) nearest before storage (feature_extraction_core/models.py:91-93)."""
    return module._head_feature_nchw(images, do_preprocess=True)
