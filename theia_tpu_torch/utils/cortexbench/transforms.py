"""CortexBench input transforms (port of theia_tpu/utils/cortexbench/transforms.py:12-58;
reference: src/theia/utils/cortexbench/transforms.py:8-45).

Host preprocessing: numpy HWC images in, numpy out, computed on the CPU
with the port's separable resize (``ops/image.py``: bicubic, a = -0.5,
antialiased, PIL's BICUBIC) and center crop.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from theia_tpu_torch.ops.image import bicubic_resize, center_crop

_IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
_IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _resize_shortest(img: np.ndarray, size: int) -> np.ndarray:
    """The shortest side to ``size``, the other in proportion; float32."""
    h, w = img.shape[:2]
    if h <= w:
        out_h, out_w = size, int(round(w * size / h))
    else:
        out_h, out_w = int(round(h * size / w)), size
    x = torch.from_numpy(np.asarray(img, np.float32))
    return bicubic_resize(x, out_h, out_w, a=-0.5, antialias=True).numpy()


def _crop(img: np.ndarray, size: int) -> np.ndarray:
    return center_crop(torch.from_numpy(img), size, size).numpy()


def rvfm_image_transforms(output_size: int = 224) -> Callable[[np.ndarray], np.ndarray]:
    """Resize-only (bicubic); the image stays uint8, normalised inside the
    backbone (reference transforms.py:8-23)."""

    def transform(img: np.ndarray) -> np.ndarray:
        out = _resize_shortest(img, output_size)
        if out.shape[:2] != (output_size, output_size):
            out = _crop(out, output_size)
        return np.clip(np.round(out), 0, 255).astype(np.uint8)

    return transform


def vit_transforms(resize_size: int = 256, output_size: int = 224) -> Callable[[np.ndarray], np.ndarray]:
    """Resize -> crop -> scale to [0, 1] -> ImageNet normalise (:26-35)."""

    def transform(img: np.ndarray) -> np.ndarray:
        out = _crop(_resize_shortest(img, resize_size), output_size) / 255.0
        return ((out - _IMAGENET_MEAN) / _IMAGENET_STD).astype(np.float32)

    return transform


def r3m_transforms(resize_size: int = 256, output_size: int = 224) -> Callable[[np.ndarray], np.ndarray]:
    """Resize -> crop, float32 in [0, 255] (:38-45)."""

    def transform(img: np.ndarray) -> np.ndarray:
        return _crop(_resize_shortest(img, resize_size), output_size).astype(np.float32)

    return transform
