"""Teacher models of the PyTorch port: the registry and the towers
(port of theia_tpu/foundation/__init__.py)."""

from theia_tpu_torch.foundation.common import (
    MODELS,
    MODEL_FEATURE_SIZES,
    get_max_model_spatial_size,
    get_model_feature_size,
)
from theia_tpu_torch.foundation.clip import get_clip_feature, get_clip_model
from theia_tpu_torch.foundation.dinov2 import get_dinov2_feature, get_dinov2_model
from theia_tpu_torch.foundation.vit import (
    get_deit_feature,
    get_deit_model,
    get_vit_feature,
    get_vit_model,
)
from theia_tpu_torch.foundation.sam import get_sam_feature, get_sam_model
from theia_tpu_torch.foundation.depth_anything import (
    get_depth_anything_feature,
    get_depth_anything_model,
)
from theia_tpu_torch.foundation.llava import get_llava_vision_model, get_llava_visual_feature

__all__ = [
    "MODELS",
    "MODEL_FEATURE_SIZES",
    "get_model_feature_size",
    "get_max_model_spatial_size",
    "get_clip_feature",
    "get_clip_model",
    "get_dinov2_feature",
    "get_dinov2_model",
    "get_deit_feature",
    "get_deit_model",
    "get_vit_feature",
    "get_vit_model",
    "get_sam_feature",
    "get_sam_model",
    "get_depth_anything_feature",
    "get_depth_anything_model",
    "get_llava_vision_model",
    "get_llava_visual_feature",
]
