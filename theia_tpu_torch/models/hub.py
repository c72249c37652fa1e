"""Published Theia model names -> a built model (port of theia_tpu/models/hub.py:28-112).

``build_theia`` parses a name such as
``theaiinstitute/theia-base-patch16-224-cddsv`` into (backbone size, teacher
set) and builds the matching ``Theia`` with parameters drawn from an
explicit generator. Loading a published checkpoint file is not ported yet
(ROADMAP Queue 1); ``Theia.load_state_dict`` takes a reference-layout state
dict as it is.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import torch

from theia_tpu_torch.foundation.common import get_model_feature_size
from theia_tpu_torch.models.rvfm import Theia

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
    **kwargs: Any,
) -> Theia:
    """Build a published Theia architecture (lconv translator) in eval mode.

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
            translator="lconv",
            target_feature_sizes=sizes,
            feature_reduce_method=feature_reduce_method,
            dtype=dtype,
            **kwargs,
        )
    model.to_empty(device="cpu")
    model.reset_parameters(generator)
    return model.to(device=device, dtype=param_dtype).eval()
