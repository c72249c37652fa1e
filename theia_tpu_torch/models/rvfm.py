"""Theia: the robot-vision foundation-model student (port of theia_tpu/models/rvfm.py:31-87).

A ViT/DeiT backbone plus a feature translator with per-teacher heads:
  - ``forward_feature(x)``: backbone tokens, reduced per ``feature_reduce_method``;
  - ``forward(x, target_model_names)``: dict[teacher -> predicted feature],
    register tokens dropped before translation.
Parameter names are the reference ``RobotVisionFM`` state-dict names
(``backbone.model.*``, ``translator.translator_heads.*``).
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from theia_tpu_torch.models.translators import build_feature_translator
from theia_tpu_torch.models.utils import handle_feature_output
from theia_tpu_torch.models.vit import build_backbone


class Theia(nn.Module):
    """Student model: backbone + translator (reference RobotVisionFM).

    Inputs are uint8 images [B,H,W,C] or [B,C,H,W] (range 0-255), as tensors
    or arrays; they are moved to the model's device. ``dtype`` is the
    compute dtype of every layer (the JAX ``Theia.dtype``), whatever dtype
    the parameters are stored in. ``fuse_preprocessing`` folds the DeiT
    processor into the patch embed, ``fast_math`` runs the encoder's bf16
    softmax and tanh GELU path (the JAX fields of the same names; both are
    the training recipe's, ``theia_tpu/configs/training/frame_level.yaml``).
    """

    def __init__(
        self,
        backbone: str = "facebook/deit-small-patch16-224",
        translator: str = "lconv",
        target_feature_sizes: Optional[dict[str, tuple[int, ...]]] = None,
        translator_kwargs: Optional[dict[str, Any]] = None,
        feature_reduce_method: Optional[str] = None,
        image_size: int = 224,
        num_reg_tokens: int = 7,
        fast_math: bool = False,
        dtype: torch.dtype = torch.float32,
        fuse_preprocessing: bool = False,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.backbone = build_backbone(
            backbone,
            image_size=image_size,
            num_reg_tokens=num_reg_tokens,
            fast_math=fast_math,
            dtype=dtype,
            fuse_preprocessing=fuse_preprocessing,
        )
        self.no_cls = self.backbone.no_cls
        self.num_reg = self.backbone.num_reg_tokens
        self.feature_reduce_method = feature_reduce_method
        self.translator = None
        if target_feature_sizes:
            kwargs = dict(translator_kwargs or {})
            kwargs["backbone_feature_size"] = self.backbone.get_feature_size(keep_spatial=True)
            kwargs["target_feature_sizes"] = dict(target_feature_sizes)
            kwargs["dtype"] = dtype
            self.translator = build_feature_translator(translator, **kwargs)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every parameter from ``generator``: HF ViT init for the
        backbone, torch defaults for the heads, in a fixed order."""
        self.backbone.reset_parameters(generator)
        if self.translator is not None:
            for m in self.translator.modules():
                if hasattr(m, "reset_parameters"):
                    m.reset_parameters(generator)

    def _to_device(self, x: Any) -> torch.Tensor:
        return torch.as_tensor(x, device=next(self.parameters()).device)

    def forward_feature(self, x: Any, **kwargs: Any) -> torch.Tensor:
        """Backbone feature only (before translators)."""
        feature = self.backbone(self._to_device(x), **kwargs)
        return handle_feature_output(
            feature,
            feature_reduce_method=self.feature_reduce_method,
            num_discard_tokens=self.num_reg,
        )

    def forward(
        self,
        x: Any,
        target_model_names: Optional[list[str]] = None,
        **kwargs: Any,
    ) -> dict[str, torch.Tensor]:
        """Predict teacher features: dict[teacher -> [B, H*W, C] or [B, C]]."""
        if self.translator is None:
            raise ValueError("Theia built without target_feature_sizes has no translator")
        x = self.backbone(self._to_device(x), **kwargs)
        if self.num_reg > 0:
            x = x[:, : x.shape[1] - self.num_reg]
        return self.translator(x, target_model_names, backbone_no_cls=self.no_cls)
