"""ViT-huge / DeiT teachers — plain HF ViTModel architecture on the student's
encoder (port of theia_tpu/foundation/vit.py; reference:
src/theia/foundation_models/vision_models/vit.py:8-71, deit.py:8-52).

The port's ``ViTBackbone`` runs its attention through the hand-written
kernels (``attention_impl="pallas"``): ViT-H's 257 tokens at 16 heads of
80 go to the flash forward (K7) in each of its 32 layers, a DeiT teacher's
197 tokens to K1 in each of its 12. The JAX teachers run einsum attention.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from theia_tpu_torch.foundation.clip import to_visual_map
from theia_tpu_torch.models.vit import ViTBackbone, ViTBackboneConfig
from theia_tpu_torch.ops.image import preprocess_images

# google/vit-huge-patch14-224-in21k: ViTImageProcessor resizes straight to
# 224x224 with BILINEAR and normalizes with mean/std 0.5
VIT_HUGE = ViTBackboneConfig(
    hidden_size=1280, num_layers=32, num_heads=16, intermediate_size=5120,
    patch_size=14, image_size=224, resize_size=224, crop_size=224,
)

DEIT_TEACHERS = {
    "facebook/deit-tiny-patch16-224": ViTBackboneConfig(hidden_size=192, num_heads=3, intermediate_size=768),
    "facebook/deit-small-patch16-224": ViTBackboneConfig(hidden_size=384, num_heads=6, intermediate_size=1536),
    "facebook/deit-base-patch16-224": ViTBackboneConfig(hidden_size=768, num_heads=12, intermediate_size=3072),
}


class _ViTTeacher(ViTBackbone):
    """ViTBackbone with a processor resample override (ViT uses bilinear)."""

    def __init__(self, cfg: ViTBackboneConfig, variant: str = "cls", dtype: torch.dtype = torch.float32,
                 resample: str = "cubic") -> None:
        super().__init__(cfg, variant=variant, dtype=dtype)
        self.resample = resample

    def forward(self, x: torch.Tensor, **kwargs) -> torch.Tensor:  # type: ignore[override]
        cfg = self.cfg
        x = preprocess_images(
            x, resize_size=cfg.resize_size, crop_size=cfg.crop_size, image_mean=cfg.image_mean,
            image_std=cfg.image_std, out_dtype=self.dtype, resample=self.resample,
        )
        return super().forward(x, do_resize=False, do_rescale=False, do_normalize=False)


def _build(module: ViTBackbone, state_dict, generator) -> ViTBackbone:
    """An HF ViTModel state dict into ``module.model``: the keys the JAX
    ``convert_vit_backbone`` reads, loaded strictly; others (``pooler.*``)
    dropped. Else a seeded random init."""
    if state_dict is not None:
        own = module.model.state_dict()
        module.model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items() if k in own}, strict=True)
    else:
        module.reset_parameters(generator)
    return module.eval().requires_grad_(False)


def get_vit_model(
    model_name: str = "google/vit-huge-patch14-224-in21k",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> _ViTTeacher:
    with torch.device(device):
        module = _ViTTeacher(VIT_HUGE, variant="cls", dtype=dtype, resample="linear")
    return _build(module, state_dict, generator)


def get_vit_feature(module: ViTBackbone, images: torch.Tensor):
    """(cls_token [B,C], feature [B,C,16,16]) (reference vit.py:8-51)."""
    tokens = module(images)
    return tokens[:, 0], to_visual_map(tokens[:, 1:])


def get_deit_model(
    model_name: str = "facebook/deit-tiny-patch16-224",
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> ViTBackbone:
    with torch.device(device):
        module = ViTBackbone(DEIT_TEACHERS[model_name], variant="cls", dtype=dtype)
    return _build(module, state_dict, generator)


def get_deit_feature(module: ViTBackbone, images: torch.Tensor) -> torch.Tensor:
    """feature [B,C,14,14] (reference deit.py:8-52)."""
    return to_visual_map(module(images)[:, 1:])
