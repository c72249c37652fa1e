"""CortexBench model loader (port of theia_tpu/utils/cortexbench/load_model.py:15-45;
reference: src/theia/utils/cortexbench/load_model.py:13-40): probe the
embedding shape with a blank image and return
(forward_feature_fn, (C, H, W), transform, metadata)."""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn

from theia_tpu_torch.models.pretrained import load_theia_checkpoint


def load_model(
    model: nn.Module,
    transform: Callable[[np.ndarray], np.ndarray],
    metadata: Any = None,
    checkpoint_path: Optional[str] = None,
    **kwargs: Any,
) -> tuple[Callable[[Any], torch.Tensor], tuple[int, ...], Callable, Any]:
    """Returns (forward_feature_fn, embedding_dim, transform, metadata).

    ``model`` is a port ``Theia`` (or any module with ``forward_feature``)
    already on its device; ``checkpoint_path`` loads weights into it first
    (``models.pretrained.load_theia_checkpoint``, as the reference's
    load_pretrained_weights hook). ``forward_feature_fn`` takes a batch
    (numpy or tensor, as ``transform`` makes it) and returns the features
    [B, H*W, C] on the model's device, without autograd. The embedding dim
    is probed on a 100x100 black image: (C, H, W) for spatial tokens, else
    the feature's own shape."""
    if checkpoint_path:
        load_theia_checkpoint(checkpoint_path, model)
    device = next(model.parameters()).device

    def forward_feature(x: Any) -> torch.Tensor:
        with torch.inference_mode():
            return model.forward_feature(torch.as_tensor(x).to(device))

    probe = transform(np.zeros((100, 100, 3), np.uint8))[None]
    embedding_dim = tuple(forward_feature(probe).shape[1:])  # [H*W, C]
    if len(embedding_dim) > 1:
        h = w = int(math.isqrt(embedding_dim[0]))
        embedding_dim = (embedding_dim[1], h, w)  # [C, H, W]
    return forward_feature, embedding_dim, transform, metadata
