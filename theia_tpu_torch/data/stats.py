"""Teacher-feature statistics: load and normalize (port of theia_tpu/data/stats.py).

Reference semantics: channel-wise mean and std (stored under the historical
name "var") computed over ImageNet, stored as float32 npy vectors; features
are normalized (x - mean) / std in bf16, each operation rounded to bf16
(reference: src/theia/dataset/data_utils.py:342-380;
scripts/preprocessing/calc_feature_mean.py:41-91; feature_stats/*.npy).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch


def load_feature_stats(
    stats_root: str, feature_models: list[str], dtype: torch.dtype = torch.bfloat16
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """Load imagenet_{mean,var}_<model>.npy per model (data_utils.py:358-380) as CPU tensors."""
    means: dict[str, torch.Tensor] = {}
    stds: dict[str, torch.Tensor] = {}
    for model in feature_models:
        name = model.replace("/", "_")
        for table, kind in ((means, "mean"), (stds, "var")):
            arr = np.load(os.path.join(stats_root, f"imagenet_{kind}_{name}.npy"))
            table[model] = torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
    return means, stds


def normalize_feature(
    x: torch.Tensor, mean: Optional[torch.Tensor] = None, std: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(x - mean) / std in x's dtype; identity when stats are missing (data_utils.py:342-355)."""
    if mean is None or std is None:
        return x
    return ((x - mean) / std).to(x.dtype)


def denormalize_feature(x: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    """x * std + mean in x's dtype, the inverse of ``normalize_feature``
    (the JAX package's; ``decoding/decode.py`` keeps its own helper, which
    also takes a missing mean or std)."""
    return (x * std + mean).to(x.dtype)
