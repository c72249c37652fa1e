"""Theia student model in PyTorch: ViT backbone, lconv translator heads, weight conversion.

The public names are the JAX package's (``theia_tpu/models/__init__.py``).
"""

from theia_tpu_torch.models.vit import BACKBONE_CONFIGS, ViTBackbone, ViTBackboneConfig, build_backbone
from theia_tpu_torch.models.utils import handle_feature_output
from theia_tpu_torch.models.activations import get_activation_fn

__all__ = [
    "ViTBackboneConfig",
    "ViTBackbone",
    "build_backbone",
    "BACKBONE_CONFIGS",
    "handle_feature_output",
    "get_activation_fn",
]
