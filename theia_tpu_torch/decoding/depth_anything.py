"""Depth decoding from predicted Depth-Anything head features (port of
theia_tpu/decoding/depth_anything.py:22-63; reference:
src/theia/decoding/depth_anything.py:11-57): the 32-channel feature,
nearest-resized to 224², through the pretrained head's tail (ReLU, the 1x1
``head.conv3``, ReLU), min-max normalised per image."""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.foundation.depth_anything import DEPTH_ANYTHING_LARGE, DepthAnything
from theia_tpu_torch.foundation.towers import init_weights_
from theia_tpu_torch.ops.image import interpolate_nearest


def prepare_depth_decoder(
    model_name: str = "LiheYoung/depth-anything-large-hf",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    module: Optional[DepthAnything] = None,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> tuple[nn.Conv2d, int]:
    """(the head tail's 1x1 conv on ``device``, patch size). The conv is the
    port's ``DepthAnything.head.conv3``: a built model's (``module``), or
    one loaded from an HF ``DepthAnythingForDepthEstimation`` state dict's
    ``head.conv3.*``, else a seeded random init (``generator`` on ``device``)."""
    cfg = DEPTH_ANYTHING_LARGE
    if module is not None:
        conv = module.head.conv3
    else:
        with torch.device(device):
            conv = nn.Conv2d(cfg.head_hidden_size, 1, 1)
        if state_dict is not None:
            conv.load_state_dict({k: torch.as_tensor(state_dict[f"head.conv3.{k}"]) for k in ("weight", "bias")})
        else:
            init_weights_(conv, generator)
    return conv.eval().requires_grad_(False), cfg.patch_size


@torch.inference_mode()
def decode_depth_anything(features: Any, decoder: nn.Conv2d) -> np.ndarray:
    """[B, num_tokens, 32] predicted head features -> [B, 224, 224, 3] in [0, 1],
    on the decoder's device. The 1x1 conv runs before the nearest resize,
    which repeats its per-pixel values exactly as resizing first would."""
    weight = decoder.weight
    x = torch.as_tensor(features, device=weight.device).float()
    b, n, c = x.shape
    p = int(n ** 0.5)
    x = F.relu(x.reshape(b, p, p, c)).permute(0, 3, 1, 2)
    x = F.relu(F.conv2d(x, weight.float(), decoder.bias.float()))  # [B, 1, p, p]
    x = interpolate_nearest(x.permute(0, 2, 3, 1), 224, 224)[..., 0]
    lo, hi = x.amin(dim=(1, 2), keepdim=True), x.amax(dim=(1, 2), keepdim=True)
    out = (x - lo) / (hi - lo).clamp(min=1e-12)
    return out[..., None].expand(-1, -1, -1, 3).cpu().numpy()
