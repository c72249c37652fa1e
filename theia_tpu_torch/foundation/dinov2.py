"""DINOv2 teacher (port of theia_tpu/foundation/dinov2.py; reference:
src/theia/foundation_models/vision_models/dinov2.py:8-76)."""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from theia_tpu_torch.foundation.clip import to_visual_map
from theia_tpu_torch.foundation.towers import DINOV2_LARGE, Dinov2Tower, build_tower


def get_dinov2_model(
    model_name: str = "facebook/dinov2-large",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> Dinov2Tower:
    """The DINOv2 tower on ``device``: an HF Dinov2Model state dict loaded
    strictly, else a seeded random init."""
    return build_tower(Dinov2Tower, DINOV2_LARGE, dtype, device, state_dict, generator)


def get_dinov2_feature(module: Dinov2Tower, images: torch.Tensor):
    """(cls_token [B,1,C], visual_tokens [B,C,16,16], pooled_cls [B,1,C])."""
    tokens, pooled = module(images)
    return tokens[:, :1], to_visual_map(tokens[:, 1:]), pooled[:, None]
