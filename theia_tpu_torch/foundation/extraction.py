"""Teacher feature extraction core: model dispatch + per-batch outputs.

Port of theia_tpu/foundation/extraction.py:28-102 (reference
preprocessing/feature_extraction_core/models.py): ``get_model`` dispatches
by name (:25-40), ``get_feature_outputs`` runs a teacher batch and packages
bf16 features for ``data.webdataset.save_safetensors`` with the exact
per-teacher key layout (:55-97):
  - google/vit:        {cls_token [C], embedding [C,16,16]}
  - facebook/sam:      {embedding [C,64,64]} (+ a _32 variant interpolated
                       to 32x32)
  - openai/clip:       {embedding, cls_token, pooled_cls_token}
  - facebook/dinov2:   {embedding, cls_token, pooled_cls_token}
  - llava:             {embedding [C,24,24]}
  - depth-anything:    {embedding interpolated to [32,64,64]}

``extract_batch`` is one batch of ``scripts/feature_extraction.py``
``extract_shard``: a uint8 host batch to the module's device, the features,
both stores read back as bf16 host tensors, split into samples. It records
the spans ``extract.batch`` around ``extract.stage`` (the copy to the
device), ``extract.forward`` and ``extract.readback`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
from torch import nn

from theia_tpu_torch.ops.image import interpolate_nearest
from theia_tpu_torch.utils.profiling import span


# (name substring, model constructor, feature function) in the reference's
# dispatch order (models.py:25-40)
_TEACHERS = (
    ("google/vit", "get_vit_model", "get_vit_feature"),
    ("facebook/sam", "get_sam_model", "get_sam_feature"),
    ("openai/clip", "get_clip_model", "get_clip_feature"),
    ("facebook/dinov2", "get_dinov2_model", "get_dinov2_feature"),
    ("llava", "get_llava_vision_model", "get_llava_visual_feature"),
    ("depth-anything", "get_depth_anything_model", "get_depth_anything_feature"),
)


def _lookup(model_name: str) -> tuple[Callable, Callable]:
    from theia_tpu_torch import foundation as f

    for key, make, feature in _TEACHERS:
        if key in model_name:
            return getattr(f, make), getattr(f, feature)
    raise NotImplementedError(f"{model_name} is not implemented")


def get_model(
    model_name: str,
    state_dict: Optional[Mapping[str, torch.Tensor]] = None,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
    generator: Optional[torch.Generator] = None,
) -> tuple[nn.Module, Callable]:
    """(module, feature_fn) by teacher name; the module holds ``state_dict``
    (HF names) or a seeded random init (``generator`` on ``device``) on
    ``device``, in eval mode."""
    make, feature_fn = _lookup(model_name)
    return make(model_name, state_dict=state_dict, dtype=dtype, device=device, generator=generator), feature_fn


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16)


def _nearest_nchw(x: torch.Tensor, size: int) -> torch.Tensor:
    return interpolate_nearest(x.permute(0, 2, 3, 1), size, size).permute(0, 3, 1, 2)


def _to_host(features: dict[str, dict[str, torch.Tensor]]) -> dict[str, dict[str, torch.Tensor]]:
    return {store: {k: v.cpu() for k, v in keys.items()} for store, keys in features.items()}


def get_feature_outputs(
    model_name: str,
    module: nn.Module,
    batch_images: torch.Tensor,
    feature_fn: Optional[Callable] = None,
) -> dict[str, dict[str, torch.Tensor]]:
    """Run one teacher batch -> {store_name: {key: bf16 CPU tensor}} with the
    reference's key layout (models.py:55-97). ``batch_images`` is uint8
    [B,H,W,3] on the module's device."""
    return _to_host(device_feature_outputs(model_name, module, batch_images, feature_fn))


@torch.inference_mode()
def device_feature_outputs(
    model_name: str,
    module: nn.Module,
    batch_images: torch.Tensor,
    feature_fn: Optional[Callable] = None,
) -> dict[str, dict[str, torch.Tensor]]:
    """``get_feature_outputs`` with the bf16 features left on the module's device."""
    name = model_name.replace("/", "_")
    if feature_fn is None:
        feature_fn = _lookup(model_name)[1]

    features: dict[str, dict[str, torch.Tensor]] = {}
    if "google_vit" in name:
        cls_token, feature = feature_fn(module, batch_images)
        features[name] = {"cls_token": _bf16(cls_token), "embedding": _bf16(feature)}
    elif "facebook_sam" in name:
        feature, _ = feature_fn(module, batch_images)  # [B,256,64,64]
        features[name] = {"embedding": _bf16(feature)}
        features[name + "_32"] = {"embedding": _bf16(_nearest_nchw(feature, 32))}
    elif "openai_clip" in name or "facebook_dinov2" in name:
        cls_token, visual_tokens, pooled = feature_fn(module, batch_images)
        features[name] = {
            "embedding": _bf16(visual_tokens),
            "cls_token": _bf16(cls_token),
            "pooled_cls_token": _bf16(pooled),
        }
    elif "llava" in name:
        features[name] = {"embedding": _bf16(feature_fn(module, batch_images))}
    elif "depth-anything" in name:
        feature = feature_fn(module, batch_images)  # [B,32,518,518]
        features[name] = {"embedding": _bf16(_nearest_nchw(feature, 64))}
    else:
        raise NotImplementedError(f"model {model_name} is not supported")
    return features


def extract_batch(
    model_name: str,
    module: nn.Module,
    host_images: torch.Tensor,
    feature_fn: Optional[Callable] = None,
    unit: Optional[int] = None,
) -> list[dict[str, torch.Tensor]]:
    """One extraction batch: uint8 host images [B,H,W,3] -> one dict a
    sample of the teacher's own store ({key: bf16 CPU tensor}), what
    ``extract_shard`` writes a sample. Every store, the ``_32`` one included,
    is read back to the host before it returns. ``unit`` (the batch's index)
    tags its spans."""
    device = next(module.parameters()).device
    with span("extract.batch", unit):
        with span("extract.stage", unit):
            images = host_images.to(device)
        with span("extract.forward", unit):
            features = device_feature_outputs(model_name, module, images, feature_fn)
        with span("extract.readback", unit):
            features = _to_host(features)
    own = features[model_name.replace("/", "_")]
    return [{k: v[j] for k, v in own.items()} for j in range(host_images.shape[0])]
