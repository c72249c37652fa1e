"""LLaVA visual teacher: the CLIP ViT-L/14-336 tower, features from hidden
layer -2, CLS dropped (port of theia_tpu/foundation/llava.py; reference:
src/theia/foundation_models/vision_language_models/llava.py:24-145).
Excluded from training in the reference (train_rvfm.py:235); provided for
extraction parity.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import torch

from theia_tpu_torch.foundation.clip import to_visual_map
from theia_tpu_torch.foundation.towers import CLIP_VIT_LARGE, CLIPVisionTower, build_tower, strip_prefix

# llava-1.5's vision tower: CLIP ViT-L/14 at 336px -> 24x24 patches
LLAVA_VISION = dataclasses.replace(CLIP_VIT_LARGE, image_size=336, resize_size=336, crop_size=336)


def get_llava_vision_model(
    model_name: str = "llava-hf/llava-1.5-7b-hf",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> CLIPVisionTower:
    """The tower on ``device``: a full LlavaForConditionalGeneration state
    dict (``vision_tower.`` prefix) or the tower's own, loaded strictly; else
    a seeded random init."""
    if state_dict is not None:
        state_dict = {k: v for k, v in strip_prefix(strip_prefix(state_dict, "vision_tower."), "vision_model.").items()
                      if not k.endswith("position_ids")}
    return build_tower(CLIPVisionTower, LLAVA_VISION, dtype, device, state_dict, generator)


def get_llava_visual_feature(module: CLIPVisionTower, images: torch.Tensor, vision_feature_layer: int = -2):
    """[B, C, 24, 24] visual tokens from hidden layer -2, CLS dropped
    ("default" select strategy; reference llava.py:66-80)."""
    idx = vision_feature_layer % (module.cfg.num_layers + 1)
    _, _, states = module(images, output_hidden_indices=(idx,))
    return to_visual_map(states[0][:, 1:])
