"""JAX Theia and teacher parameters -> the port's state dicts.

Port of theia_tpu/models/hf_convert.py:211-295 (``export_vit_backbone`` and
``export_theia_checkpoint``), written without JAX: the input is the JAX
param tree with numpy (or array-like) leaves. The output names and layouts
are the reference ``RobotVisionFM`` state dict, which is also the port's
``Theia.state_dict()``, so ``Theia.load_state_dict(sd, strict=True)`` loads it.

The teachers' functions (``clip_vision_state_dict`` ...) invert the JAX
package's HF converters (``theia_tpu/foundation/towers.py:231,258``,
``sam.py:185``, ``depth_anything.py:220``; ViT-H and DeiT through
``_backbone``): they give HF's names and layouts, which are the port's
towers' own, so a JAX ``module.init`` tree loads with ``strict=True``.
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


def _hwio_to_oihw(kernel: Any) -> np.ndarray:
    return np.asarray(kernel).transpose(3, 2, 0, 1)


def _patch_weight(kernel: Any) -> np.ndarray:
    """Matmul patch kernel ((kh, kw, 3) flattened, C) -> conv weight (C, 3, kh, kw)."""
    kernel = np.asarray(kernel)
    c = kernel.shape[1]
    p = int((kernel.shape[0] // 3) ** 0.5)
    return kernel.reshape(p, p, 3, c).transpose(3, 2, 0, 1)


def _linear(sd: dict, name: str, leaf: Mapping[str, Any]) -> None:
    sd[name + ".weight"] = np.asarray(leaf["kernel"]).T
    sd[name + ".bias"] = np.asarray(leaf["bias"])


def _norm(sd: dict, name: str, leaf: Mapping[str, Any]) -> None:
    sd[name + ".weight"] = np.asarray(leaf["scale"] if "scale" in leaf else leaf["weight"])
    sd[name + ".bias"] = np.asarray(leaf["bias"])


def _tensors(sd: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in sd.items()}


def _layers(params: Mapping[str, Any]) -> int:
    n = 0
    while f"layer_{n}_fc1" in params or f"layer_{n}_lin1" in params:
        n += 1
    return n


def _clip(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    sd: dict[str, np.ndarray] = {
        "embeddings.class_embedding": np.asarray(params["class_embedding"]),
        "embeddings.patch_embedding.weight": _patch_weight(params["patch_kernel"]),
        "embeddings.position_embedding.weight": np.asarray(params["position_embedding"]),
    }
    _norm(sd, "pre_layrnorm", params["pre_layrnorm"])
    _norm(sd, "post_layernorm", params["post_layernorm"])
    for i in range(_layers(params)):
        lp = f"encoder.layers.{i}."
        for src, dst in (("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"), ("out", "out_proj")):
            _linear(sd, lp + "self_attn." + dst, params[f"layer_{i}_{src}"])
        _linear(sd, lp + "mlp.fc1", params[f"layer_{i}_fc1"])
        _linear(sd, lp + "mlp.fc2", params[f"layer_{i}_fc2"])
        _norm(sd, lp + "layer_norm1", params[f"layer_{i}_ln1"])
        _norm(sd, lp + "layer_norm2", params[f"layer_{i}_ln2"])
    return sd


def clip_vision_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``CLIPVisionTower`` params -> the port's (HF ``CLIPVisionTransformer``) state dict."""
    return _tensors(_clip(params))


def _dinov2(params: Mapping[str, Any]) -> dict[str, np.ndarray]:
    cls_token = np.asarray(params["cls_token"])
    sd: dict[str, np.ndarray] = {
        "embeddings.cls_token": cls_token,
        # HF's mask token (zeros at init); the JAX tower has none and never uses it
        "embeddings.mask_token": np.zeros((1, cls_token.shape[-1]), np.float32),
        "embeddings.position_embeddings": np.asarray(params["position_embeddings"]),
        "embeddings.patch_embeddings.projection.weight": _patch_weight(params["patch_kernel"]),
        "embeddings.patch_embeddings.projection.bias": np.asarray(params["patch_bias"]),
    }
    _norm(sd, "layernorm", params["layernorm"])
    for i in range(_layers(params)):
        lp = f"encoder.layer.{i}."
        for src, dst in (("q", "attention.attention.query"), ("k", "attention.attention.key"),
                         ("v", "attention.attention.value"), ("out", "attention.output.dense"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
            _linear(sd, lp + dst, params[f"layer_{i}_{src}"])
        _norm(sd, lp + "norm1", params[f"layer_{i}_norm1"])
        _norm(sd, lp + "norm2", params[f"layer_{i}_norm2"])
        sd[lp + "layer_scale1.lambda1"] = np.asarray(params[f"layer_{i}_lambda1"])
        sd[lp + "layer_scale2.lambda1"] = np.asarray(params[f"layer_{i}_lambda2"])
    return sd


def dinov2_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``Dinov2Tower`` params -> the port's (HF ``Dinov2Model``) state dict."""
    return _tensors(_dinov2(params))


def sam_vision_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ``SamVisionEncoder`` params -> the port's (HF ``SamVisionEncoder``) state dict."""
    sd: dict[str, np.ndarray] = {
        "pos_embed": np.asarray(params["pos_embed"]),
        "patch_embed.projection.weight": _patch_weight(params["patch_kernel"]),
        "patch_embed.projection.bias": np.asarray(params["patch_bias"]),
        "neck.conv1.weight": _hwio_to_oihw(params["neck_conv1"]),
        "neck.conv2.weight": _hwio_to_oihw(params["neck_conv2"]),
    }
    _norm(sd, "neck.layer_norm1", params["neck_ln1"])
    _norm(sd, "neck.layer_norm2", params["neck_ln2"])
    for i in range(_layers(params)):
        lp = f"layers.{i}."
        _norm(sd, lp + "layer_norm1", params[f"layer_{i}_ln1"])
        _norm(sd, lp + "layer_norm2", params[f"layer_{i}_ln2"])
        _linear(sd, lp + "attn.qkv", params[f"layer_{i}_qkv"])
        _linear(sd, lp + "attn.proj", params[f"layer_{i}_proj"])
        _linear(sd, lp + "mlp.lin1", params[f"layer_{i}_lin1"])
        _linear(sd, lp + "mlp.lin2", params[f"layer_{i}_lin2"])
        sd[lp + "attn.rel_pos_h"] = np.asarray(params[f"layer_{i}_rel_pos_h"])
        sd[lp + "attn.rel_pos_w"] = np.asarray(params[f"layer_{i}_rel_pos_w"])
    return _tensors(sd)


def depth_anything_state_dict(
    params: Mapping[str, Any], reassemble_factors: tuple[float, ...] = (4, 2, 1, 0.5)
) -> dict[str, torch.Tensor]:
    """JAX ``DepthAnything`` params -> the port's (HF
    ``DepthAnythingForDepthEstimation``) state dict; ``reassemble_factors``
    is the config's."""
    sd = {"backbone." + k: v for k, v in _dinov2(params["backbone_module"]).items()}
    for i, factor in enumerate(reassemble_factors):
        rp = f"neck.reassemble_stage.layers.{i}."
        sd[rp + "projection.weight"] = _hwio_to_oihw(params[f"reassemble_{i}_proj_kernel"])
        sd[rp + "projection.bias"] = np.asarray(params[f"reassemble_{i}_proj_bias"])
        if factor != 1:
            k = np.asarray(params[f"reassemble_{i}_resize_kernel"])
            # a transposed conv's (kh, kw, in, out) -> ConvTranspose2d (in, out, kh, kw); a conv's HWIO -> OIHW
            sd[rp + "resize.weight"] = k.transpose(2, 3, 0, 1) if factor > 1 else _hwio_to_oihw(k)
            sd[rp + "resize.bias"] = np.asarray(params[f"reassemble_{i}_resize_bias"])
        sd[f"neck.convs.{i}.weight"] = _hwio_to_oihw(params[f"neck_conv_{i}_kernel"])
        fp = f"neck.fusion_stage.layers.{i}."
        sd[fp + "projection.weight"] = _hwio_to_oihw(params[f"fusion_{i}_proj_kernel"])
        sd[fp + "projection.bias"] = np.asarray(params[f"fusion_{i}_proj_bias"])
        for r in (1, 2):
            for c in (1, 2):
                sd[fp + f"residual_layer{r}.convolution{c}.weight"] = _hwio_to_oihw(
                    params[f"fusion_{i}_res{r}_conv{c}_kernel"])
                sd[fp + f"residual_layer{r}.convolution{c}.bias"] = np.asarray(params[f"fusion_{i}_res{r}_conv{c}_bias"])
    for j in (1, 2, 3):
        sd[f"head.conv{j}.weight"] = _hwio_to_oihw(params[f"head_conv{j}_kernel"])
        sd[f"head.conv{j}.bias"] = np.asarray(params[f"head_conv{j}_bias"])
    return _tensors(sd)


def vit_teacher_state_dict(params: Mapping[str, Any]) -> dict[str, torch.Tensor]:
    """JAX ViT-H / DeiT teacher (``ViTBackbone``) params -> the state dict of
    the port teacher's ``model`` (HF ``ViTModel`` names, no pooler)."""
    return _tensors(_backbone(params, "cls", prefix=""))


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
