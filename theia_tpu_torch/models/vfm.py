"""Baseline VFM encoders (port of theia_tpu/models/vfm.py:19-138; reference:
src/theia/models/vfm.py:13-204).

Any single teacher, or a concatenation of several, behind the same
``forward_feature`` API as Theia, for baseline comparisons. The towers are
the port's (``foundation/``), built on ``device`` from an HF state dict
(or the JAX params carried across by ``models.convert``), else from a
seeded random init. The external robot-learning baselines (NVIDIA RADIO,
MVP, VIP, R3M) are import-gated exactly as in the JAX package: optional
extras there too.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from theia_tpu_torch import foundation as f
from theia_tpu_torch.models.utils import handle_feature_output

_TOWERS = (
    ("google/vit", f.get_vit_model),
    ("facebook/dino", f.get_dinov2_model),
    ("facebook/sam", f.get_sam_model),
    ("openai/clip", f.get_clip_model),
    ("facebook/deit", f.get_deit_model),
)


class VFMEncoder:
    """One off-the-shelf teacher behind ``forward_feature``: uint8 images
    [B, H, W, 3] (numpy or a tensor) in, features on the tower's device out."""

    def __init__(
        self,
        model_name: str,
        feature_reduce_method: Optional[str] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        dtype: torch.dtype = torch.float32,
        device: str | torch.device = "cuda",
        generator: Optional[torch.Generator] = None,
        **kwargs: Any,
    ) -> None:
        self.model_name = model_name
        self.feature_reduce_method = feature_reduce_method
        self.device = torch.device(device)
        getter = next((g for key, g in _TOWERS if key in model_name), None)
        if getter is not None:
            self.module = getter(model_name, state_dict=state_dict, dtype=dtype, device=self.device,
                                 generator=generator)
        elif "nvidia" in model_name:
            # RADIO baseline: an HF remote-code model (reference vfm.py:43-45)
            from transformers import AutoImageProcessor, AutoModel

            self.module = AutoModel.from_pretrained(model_name, trust_remote_code=True).to(self.device)
            self._radio_processor = AutoImageProcessor.from_pretrained(model_name)
        elif "mvp" in model_name:
            import mvp  # optional external baseline (reference vfm.py:47-51)

            self.module = mvp.load(model_name.replace("mvp-", ""))
        elif "vip" in model_name:
            from vip import load_vip

            self.module = load_vip()
        elif "r3m" in model_name:
            from r3m import load_r3m

            self.module = load_r3m(model_name.replace("r3m-", ""))
        else:
            raise NotImplementedError(f"{model_name} is not supported in theia_tpu_torch.models.vfm")
        self.image_size = kwargs.get("image_size", 224)
        self.final_spatial = kwargs.get("final_spatial")

    def load_state_dict(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        """The tower's weights, loaded strictly (the JAX ``load_params``)."""
        self.module.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)

    @torch.inference_mode()
    def get_feature(self, x: Any, **kwargs: Any) -> torch.Tensor:
        if "nvidia" in self.model_name:
            import numpy as np

            inputs = self._radio_processor(images=list(np.asarray(x)), return_tensors="pt")
            summary, feature = self.module(inputs["pixel_values"].to(self.device, torch.bfloat16))
            return (summary if self.feature_reduce_method == "cls_identity" else feature).float()
        x = torch.as_tensor(x).to(self.device)
        if "facebook/sam" in self.model_name:
            out = self.module(x)  # NHWC [B, 64, 64, 256]
            b, h, w, c = out.shape
            return out.reshape(b, h * w, c)
        if "openai/clip" in self.model_name or "facebook/dino" in self.model_name:
            tokens, _ = self.module(x)
            return tokens
        return self.module(x)

    def forward(self, x: Any, **kwargs: Any) -> torch.Tensor:
        feature = self.get_feature(x, **kwargs)
        if "facebook/sam" in self.model_name:
            # a spatial feature map only: no CLS to strip
            return handle_feature_output(feature, self.feature_reduce_method or "identity")
        return handle_feature_output(feature, self.feature_reduce_method)

    __call__ = forward

    def forward_feature(self, x: Any, **kwargs: Any) -> torch.Tensor:
        return self.forward(x, **kwargs)


class ConcatVFMEncoder:
    """Several teachers' features concatenated along the channels, each cut
    to the fewest tokens among them (reference vfm.py:141-204)."""

    def __init__(
        self,
        model_names: list[str],
        feature_reduce_method: Optional[str] = None,
        state_dicts: Optional[Mapping[str, Mapping[str, torch.Tensor]]] = None,
        **kwargs: Any,
    ) -> None:
        state_dicts = state_dicts or {}
        self.encoders = [VFMEncoder(m, feature_reduce_method, state_dicts.get(m), **kwargs) for m in model_names]
        self.feature_reduce_method = feature_reduce_method

    def forward(self, x: Any, **kwargs: Any) -> torch.Tensor:
        feats = [e.forward(x, **kwargs) for e in self.encoders]
        if feats[0].dim() == 3:
            n = min(t.shape[1] for t in feats)
            feats = [t[:, :n] for t in feats]
        return torch.cat(feats, dim=-1)

    __call__ = forward

    def forward_feature(self, x: Any, **kwargs: Any) -> torch.Tensor:
        return self.forward(x, **kwargs)
