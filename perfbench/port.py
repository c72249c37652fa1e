"""The system under test, built from a configuration file: ``theia_tpu_torch``'s
``Theia`` with the configuration's backbone and light-conv heads, created
without storage on the device and loaded ``strict=True`` from the
benchmark's parameters (the reference's state-dict layout)."""

from __future__ import annotations

import torch
from torch import nn


def build(cfg: dict, params: dict[str, torch.Tensor], *, dtype: torch.dtype, fast_math: bool = False,
          fuse_preprocessing: bool = False) -> nn.Module:
    """The model on ``params``' device, parameters copied from ``params``."""
    from theia_tpu_torch.models.rvfm import Theia

    device = next(iter(params.values())).device
    with torch.device("meta"):
        model = Theia(
            backbone=cfg["backbone"],
            translator=cfg["translator"],
            target_feature_sizes={t: tuple(s) for t, s in cfg["teachers"].items()},
            translator_kwargs={"hidden_size_factor": cfg.get("hidden_size_factor", 1.0)},
            image_size=cfg["image_size"],
            dtype=dtype,
            fast_math=fast_math,
            fuse_preprocessing=fuse_preprocessing,
        )
    layers = model.backbone.model.encoder["layer"]
    if cfg["num_hidden_layers"] < len(layers):  # a configuration cut in depth
        model.backbone.model.encoder["layer"] = nn.ModuleList(list(layers)[: cfg["num_hidden_layers"]])
    bb = model.backbone.cfg
    built = (bb.hidden_size, len(model.backbone.model.encoder["layer"]), bb.num_heads, bb.intermediate_size, bb.patch_size)
    want = (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["num_attention_heads"], cfg["intermediate_size"],
            cfg["patch_size"])
    if built != want:
        raise ValueError(f"the program's {cfg['backbone']} is {built}, the configuration says {want}")
    model.to_empty(device=device)
    model.load_state_dict(params, strict=True)
    return model
