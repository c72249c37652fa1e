"""CLIP vision teacher (port of theia_tpu/foundation/clip.py; reference:
src/theia/foundation_models/vision_language_models/clip.py:8-80)."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from theia_tpu_torch.foundation.towers import CLIP_VIT_LARGE, CLIPVisionTower, build_tower, strip_prefix


def get_clip_model(
    model_name: str = "openai/clip-vit-large-patch14",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> CLIPVisionTower:
    """The CLIP vision tower on ``device``: an HF CLIPVisionModel (or CLIPModel)
    state dict loaded strictly, with or without the ``vision_model.`` prefix;
    else a seeded random init (``generator`` on ``device``)."""
    if state_dict is not None:
        state_dict = {k: v for k, v in strip_prefix(state_dict, "vision_model.").items()
                      if not k.endswith("position_ids")}
    return build_tower(CLIPVisionTower, CLIP_VIT_LARGE, dtype, device, state_dict, generator)


def to_visual_map(tokens: torch.Tensor) -> torch.Tensor:
    """[B, N, C] patch tokens -> [B, C, s, s]."""
    b, n, c = tokens.shape
    s = int(n ** 0.5)
    return tokens.transpose(1, 2).reshape(b, c, s, s)


def get_clip_feature(module: CLIPVisionTower, images: torch.Tensor):
    """(cls_token [B,1,C], visual_tokens [B,C,16,16], pooled_cls [B,1,C]) —
    matches reference get_clip_feature (clip.py:8-45)."""
    tokens, pooled = module(images)
    return tokens[:, :1], to_visual_map(tokens[:, 1:]), pooled[:, None]
