"""Published Theia model names -> a built model (port of theia_tpu/models/hub.py:28-112).

``build_theia`` parses a name such as
``theaiinstitute/theia-base-patch16-224-cddsv`` into (backbone size, teacher
set) and builds the matching ``Theia`` with parameters drawn from an
explicit generator. ``from_pretrained`` builds it and loads a local
checkpoint (``models/pretrained.py``: the port's checkpoint directory or
``.pt`` train state, a reference ``.pth`` or ``.safetensors`` state dict)
into a ``PretrainedTheia``, which ``serving.Predictor`` and
``export.export_model`` take as they take a ``Theia``:

    model = from_pretrained("theaiinstitute/theia-base-patch16-224-cddsv", checkpoint_path=ckpt)
    feature = model.forward_feature(images)            # uint8 [B,H,W,C]
    preds = model(images)                              # dict[teacher, feature]
    model.feature_reduce_method = "mean_pooling"

The JAX function's fallback to a hub download is not ported: the port
needs no hub client, so without ``checkpoint_path`` it raises
``FileNotFoundError``, as the JAX one does when its fetch fails.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch
from torch import nn

from theia_tpu_torch.foundation.common import get_model_feature_size
from theia_tpu_torch.models.pretrained import load_theia_checkpoint
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.models.utils import handle_feature_output

TEACHER_SETS = {
    "cdiv": ["google/vit-huge-patch14-224-in21k", "facebook/dinov2-large", "openai/clip-vit-large-patch14"],
    "cddsv": [
        "google/vit-huge-patch14-224-in21k", "facebook/dinov2-large",
        "openai/clip-vit-large-patch14", "facebook/sam-vit-huge",
        "LiheYoung/depth-anything-large-hf",
    ],
    "cdds": ["facebook/dinov2-large", "openai/clip-vit-large-patch14", "facebook/sam-vit-huge", "LiheYoung/depth-anything-large-hf"],
    "cddv": ["google/vit-huge-patch14-224-in21k", "facebook/dinov2-large", "openai/clip-vit-large-patch14", "LiheYoung/depth-anything-large-hf"],
    "cdis": ["facebook/dinov2-large", "openai/clip-vit-large-patch14", "facebook/sam-vit-huge"],
    "cdisv": ["google/vit-huge-patch14-224-in21k", "facebook/dinov2-large", "openai/clip-vit-large-patch14", "facebook/sam-vit-huge"],
    "cdesv": ["google/vit-huge-patch14-224-in21k", "openai/clip-vit-large-patch14", "facebook/sam-vit-huge", "LiheYoung/depth-anything-large-hf"],
    "ddsv": ["google/vit-huge-patch14-224-in21k", "facebook/dinov2-large", "facebook/sam-vit-huge", "LiheYoung/depth-anything-large-hf"],
}

_NAME_RE = re.compile(r"theia-(tiny|small|base)-patch16-224(?:-([a-z]+))?")


def parse_model_name(name: str) -> tuple[str, list[str]]:
    m = _NAME_RE.search(name)
    if not m:
        raise ValueError(f"{name!r} is not a recognized theia model name")
    size, teachers = m.group(1), m.group(2) or "cdiv"
    if teachers not in TEACHER_SETS:
        raise ValueError(f"unknown teacher set {teachers!r} in {name!r}")
    return f"facebook/deit-{size}-patch16-224", TEACHER_SETS[teachers]


def build_theia(
    name: str,
    *,
    dtype: torch.dtype = torch.float32,
    param_dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    generator: Optional[torch.Generator] = None,
    feature_reduce_method: Optional[str] = None,
    translator: str = "lconv",
    **kwargs: Any,
) -> Theia:
    """Build a published Theia architecture in eval mode: its lconv
    translator, or another ``translator`` (with ``translator_kwargs``).

    ``dtype`` is the compute dtype, as the JAX ``build_theia(dtype=)``;
    ``param_dtype`` the dtype the parameters are stored in: float32, as in
    the JAX package, for training; serving may store them in the compute
    dtype, which gives the same values with no cast at each use. The
    modules are created without storage, every parameter is drawn on the
    CPU from ``generator`` (a CPU ``torch.Generator``; the global RNG when
    None), and the model then moves to ``device`` (the GPU unless the caller
    asks for the CPU) and ``param_dtype``. The other keywords go to
    ``Theia``; the training recipe (``theia_tpu/train/loop.py:150-161`` on
    ``configs/training/frame_level.yaml``) is ``dtype=torch.bfloat16,
    fast_math=True, fuse_preprocessing=True`` over float32 params.
    """
    backbone, teachers = parse_model_name(name)
    sizes = {t: get_model_feature_size(t, keep_spatial=True) for t in teachers}
    with torch.device("meta"):
        model = Theia(
            backbone=backbone,
            translator=translator,
            target_feature_sizes=sizes,
            feature_reduce_method=feature_reduce_method,
            dtype=dtype,
            **kwargs,
        )
    model.to_empty(device="cpu")
    model.reset_parameters(generator)
    return model.to(device=device, dtype=param_dtype).eval()


class PretrainedTheia(nn.Module):
    """A loaded ``Theia`` for inference, with the published usage:
    ``forward_feature`` reduces by this wrapper's ``feature_reduce_method``
    (which a caller may change after loading), ``__call__`` predicts the
    teachers' features."""

    def __init__(self, model: Theia, feature_reduce_method: Optional[str] = None) -> None:
        super().__init__()
        self.model = model
        self.feature_reduce_method = feature_reduce_method

    def forward_feature(self, x: Any, **kwargs: Any) -> torch.Tensor:
        feature = self.model.backbone(self.model._to_device(x), **kwargs)
        return handle_feature_output(feature, feature_reduce_method=self.feature_reduce_method,
                                     num_discard_tokens=self.model.num_reg)

    def forward(self, x: Any, **kwargs: Any) -> dict[str, torch.Tensor]:
        return self.model(x, **kwargs)


def from_pretrained(
    name: str,
    checkpoint_path: Optional[str] = None,
    feature_reduce_method: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str = "cuda",
    **kwargs: Any,
) -> PretrainedTheia:
    """Build the published architecture ``name`` on ``device`` (the GPU
    unless the caller asks for the CPU) in compute ``dtype`` and load
    ``checkpoint_path`` into it (``models/pretrained.py``). The other
    keywords go to ``build_theia`` (``param_dtype=torch.bfloat16`` stores a
    bf16 server's weights in bf16). Names the model does not take keep the
    initial values of a fixed seed, as the JAX function's ``PRNGKey(0)``."""
    if checkpoint_path is None:
        raise FileNotFoundError(f"no checkpoint_path given for {name}, and the port fetches nothing from a hub")
    model = build_theia(name, dtype=dtype, device=device, generator=torch.Generator().manual_seed(0),
                        feature_reduce_method=feature_reduce_method, **kwargs)
    load_theia_checkpoint(checkpoint_path, model)
    return PretrainedTheia(model, feature_reduce_method).eval()
