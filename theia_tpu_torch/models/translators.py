"""Feature translator: per-teacher adapter heads over the student tokens.

Port of theia_tpu/models/translators.py:37,138-173,308-320, ``lconv`` only:
the production translator, whose backbone adapter is the identity. Heads
live in ``translator_heads``, keyed like the reference ``nn.ModuleDict``
(teacher name with "." -> "_").
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from theia_tpu_torch.models.adapter_heads import LightConvAdapterHead, LinearAdapterHead

Size = tuple[int, ...]


def legit_name(target_model: str) -> str:
    """Teacher name as the JAX param tree spells it ("/" and "." -> "_")."""
    return target_model.replace(".", "_").replace("/", "_")


def head_key(target_model: str) -> str:
    """Teacher name as the reference state dict spells it ("." -> "_")."""
    return target_model.replace(".", "_")


class LightConvFeatureTranslator(nn.Module):
    """No pre-adapter; a LightConvAdapterHead per teacher, or a
    LinearAdapterHead for ``<teacher>_cls`` targets."""

    def __init__(
        self,
        backbone_feature_size: Size,
        target_feature_sizes: dict[str, Size],
        hidden_size_factor: float = 1.0,
        dtype: torch.dtype = torch.float32,
    ) -> None:
        super().__init__()
        self.target_feature_sizes = dict(target_feature_sizes)
        heads: dict[str, nn.Module] = {}
        for t, size in self.target_feature_sizes.items():
            if "_cls" in t:
                heads[head_key(t)] = LinearAdapterHead(backbone_feature_size, size, dtype)
            else:
                heads[head_key(t)] = LightConvAdapterHead(backbone_feature_size, size, hidden_size_factor, dtype)
        self.translator_heads = nn.ModuleDict(heads)

    def forward(
        self,
        x: torch.Tensor,
        target_model_names: Optional[list[str]] = None,
        backbone_no_cls: bool = False,
    ) -> dict[str, torch.Tensor]:
        names = target_model_names if target_model_names is not None else list(self.target_feature_sizes)
        return {t: self.translator_heads[head_key(t)](x, backbone_no_cls=backbone_no_cls) for t in names}


def build_feature_translator(translator_type: str, **kwargs: Any) -> nn.Module:
    if translator_type == "lconv":
        return LightConvFeatureTranslator(**kwargs)
    if translator_type in ("mlp", "conv", "transformer", "trans"):
        raise NotImplementedError(
            f"translator {translator_type!r} is not ported yet (ROADMAP Queue 1, other translators)"
        )
    raise NotImplementedError(f"Requested {translator_type} is not implemented yet.")
