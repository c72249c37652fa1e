"""Teacher-model registry (copy of theia_tpu/foundation/common.py:11-34).

Kept free of both frameworks so the port never imports the JAX package.
Feature sizes are (latent_dim, height, width) and drive translator head
geometry. ``tests/test_torch_imports.py`` checks the tables equal the
originals.
"""

from __future__ import annotations

import math

MODELS = [
    "facebook/dinov2-large",
    "facebook/sam-vit-huge",
    "google/vit-huge-patch14-224-in21k",
    "llava-hf/llava-1.5-7b-hf",
    "openai/clip-vit-large-patch14",
    "LiheYoung/depth-anything-large-hf",
]

MODEL_FEATURE_SIZES: dict[str, tuple[int, int, int]] = {
    "facebook/dinov2-large": (1024, 16, 16),
    "facebook/sam-vit-huge": (256, 64, 64),
    "google/vit-huge-patch14-224-in21k": (1280, 16, 16),
    "llava-hf/llava-1.5-7b-hf": (1024, 24, 24),
    "openai/clip-vit-large-patch14": (1024, 16, 16),
    "LiheYoung/depth-anything-large-hf": (32, 64, 64),
}


def get_model_feature_size(model_name: str, keep_spatial: bool = False) -> tuple[int, ...]:
    size: tuple[int, ...] = MODEL_FEATURE_SIZES[model_name]
    if not keep_spatial:
        size = (size[0], math.prod(size[1:]))
    return size
