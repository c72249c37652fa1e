"""JAX Theia parameters -> the port's state dict.

Port of theia_tpu/models/hf_convert.py:211-295 (``export_vit_backbone`` and
``export_theia_checkpoint``), written without JAX: the input is the JAX
param tree with numpy (or array-like) leaves. The output names and layouts
are the reference ``RobotVisionFM`` state dict, which is also the port's
``Theia.state_dict()``, so ``Theia.load_state_dict(sd, strict=True)`` loads it.
Every mapping is a reshape or transpose of a leaf, so any tree of the
params' structure maps the same way: gradients and Adam moments land on
the names and layouts of the port's parameters and optimizer state.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from theia_tpu_torch.models.translators import head_key, legit_name

_BLOCK_DENSE = (
    ("query", "attention.attention.query"),
    ("key", "attention.attention.key"),
    ("value", "attention.attention.value"),
    ("attention_output", "attention.output.dense"),
    ("intermediate", "intermediate.dense"),
    ("output", "output.dense"),
)


def _backbone(params: Mapping[str, Any], variant: str, prefix: str) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    kernel = np.asarray(params["patch_kernel"])  # ((kh, kw, 3) flattened, C)
    c = kernel.shape[1]
    ps = int((kernel.shape[0] // 3) ** 0.5)
    sd[f"{prefix}embeddings.patch_embeddings.projection.weight"] = kernel.reshape(ps, ps, 3, c).transpose(3, 2, 0, 1)
    sd[f"{prefix}embeddings.patch_embeddings.projection.bias"] = np.asarray(params["patch_bias"])
    sd[f"{prefix}embeddings.position_embeddings"] = np.asarray(params["position_embeddings"])
    if variant != "nocls":
        sd[f"{prefix}embeddings.cls_token"] = np.asarray(params["cls_token"])
    if variant == "reg":
        sd[f"{prefix}embeddings.reg_token"] = np.asarray(params["reg_token"])
        sd[f"{prefix}embeddings.reg_pos_embed"] = np.asarray(params["reg_pos_embed"])
    i = 0
    while f"block_{i}" in params:
        blk = params[f"block_{i}"]
        lp = f"{prefix}encoder.layer.{i}."
        for src, dst in _BLOCK_DENSE:
            sd[lp + dst + ".weight"] = np.asarray(blk[src]["kernel"]).T
            sd[lp + dst + ".bias"] = np.asarray(blk[src]["bias"])
        for ln in ("layernorm_before", "layernorm_after"):
            sd[lp + ln + ".weight"] = np.asarray(blk[ln]["scale"])
            sd[lp + ln + ".bias"] = np.asarray(blk[ln]["bias"])
        i += 1
    sd[f"{prefix}layernorm.weight"] = np.asarray(params["layernorm"]["scale"])
    sd[f"{prefix}layernorm.bias"] = np.asarray(params["layernorm"]["bias"])
    return sd


def _translator(
    params: Mapping[str, Any], target_feature_sizes: Mapping[str, tuple[int, ...]], backbone_spatial: int
) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {}
    for t, size in target_feature_sizes.items():
        head = params[f"head_{legit_name(t)}"]
        hp = f"translator.translator_heads.{head_key(t)}."
        if "_cls" in t:
            sd[hp + "adapter.0.weight"] = np.asarray(head["adapter_0"]["kernel"]).T
            sd[hp + "adapter.0.bias"] = np.asarray(head["adapter_0"]["bias"])
            continue
        s_eff = backbone_spatial
        if "pad" in head:
            sd[hp + "pad.1.weight"] = np.asarray(head["pad"]["pad_1"]["kernel"]).transpose(2, 3, 0, 1)
            sd[hp + "pad.1.bias"] = np.asarray(head["pad"]["pad_1"]["bias"])
            s_eff = 16
        deconv_ladder = s_eff == 16 and size[1] == 64
        for idx in (0, 3, 6):  # LayerNormSpatial: (C,H,W) kept verbatim
            if f"adapter_{idx}" in head:
                sd[hp + f"adapter.{idx}.weight"] = np.asarray(head[f"adapter_{idx}"]["weight"])
                sd[hp + f"adapter.{idx}.bias"] = np.asarray(head[f"adapter_{idx}"]["bias"])
        for idx in (1, 4):  # HWIO -> ConvTranspose2d (I,O,kh,kw) or Conv2d (O,I,kh,kw)
            if f"adapter_{idx}" in head:
                k = np.asarray(head[f"adapter_{idx}"]["kernel"])
                sd[hp + f"adapter.{idx}.weight"] = k.transpose(2, 3, 0, 1) if deconv_ladder else k.transpose(3, 2, 0, 1)
                sd[hp + f"adapter.{idx}.bias"] = np.asarray(head[f"adapter_{idx}"]["bias"])
        for idx in (5, 8):  # final Linear
            if f"adapter_{idx}" in head:
                sd[hp + f"adapter.{idx}.weight"] = np.asarray(head[f"adapter_{idx}"]["kernel"]).T
                sd[hp + f"adapter.{idx}.bias"] = np.asarray(head[f"adapter_{idx}"]["bias"])
    return sd


def state_dict_from_jax(
    params: Mapping[str, Any],
    target_feature_sizes: Mapping[str, tuple[int, ...]],
    variant: str = "cls",
    backbone_spatial: int = 14,
) -> dict[str, torch.Tensor]:
    """JAX ``Theia`` params ({"backbone_module", "translator_module"}) -> state dict.

    ``backbone_spatial`` is the backbone's token grid side (14 at 224 px).
    """
    sd = _backbone(params["backbone_module"], variant, prefix="backbone.model.")
    if target_feature_sizes:
        sd.update(_translator(params["translator_module"], target_feature_sizes, backbone_spatial))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}
