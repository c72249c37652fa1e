"""JAX Theia and teacher parameters -> the port's state dicts.

Port of theia_tpu/models/hf_convert.py:211-295 (``export_vit_backbone`` and
``export_theia_checkpoint``, here for every translator type: the inverse of
``convert_translator``, :161-208), written without JAX: the input is the JAX
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


def _stem(params: Mapping[str, Any], target_feature_sizes: Mapping[str, tuple[int, ...]]) -> dict[str, np.ndarray]:
    """The transformer translator's free parameters and decoder layers."""
    sd: dict[str, np.ndarray] = {"translator.decode_tokens": np.asarray(params["decode_tokens"])}
    for t in target_feature_sizes:
        sd[f"translator.target_model_emb.{head_key(t)}"] = np.asarray(params[f"target_model_emb_{legit_name(t)}"])
    i = 0
    while f"stem_layer_{i}" in params:
        layer, lp = params[f"stem_layer_{i}"], f"translator.translator_stem.layers.{i}."
        for attn in ("self_attn", "multihead_attn"):
            sd[lp + attn + ".in_proj_weight"] = np.asarray(layer[attn]["in_proj_weight"])
            sd[lp + attn + ".in_proj_bias"] = np.asarray(layer[attn]["in_proj_bias"])
            _linear(sd, lp + attn + ".out_proj", layer[attn]["out_proj"])
        for m in ("norm1", "norm2", "norm3"):
            _norm(sd, lp + m, layer[m])
        for m in ("linear1", "linear2"):
            _linear(sd, lp + m, layer[m])
        i += 1
    return sd


def _translator(
    params: Mapping[str, Any], target_feature_sizes: Mapping[str, tuple[int, ...]], backbone_spatial: int,
    translator: str = "lconv",
) -> dict[str, np.ndarray]:
    """Inverts ``hf_convert.convert_translator`` for each translator type: a
    Conv2d's HWIO kernel to (O,I,kh,kw), a ConvTranspose2d's (kh,kw,I,O) to
    (I,O,kh,kw), a Linear's kernel transposed, LayerNorms verbatim."""
    sd: dict[str, np.ndarray] = {}
    if "backbone_adapter" in params:
        _norm(sd, "translator.backbone_adapter.0", params["backbone_adapter"]["adapter_0"])
        _linear(sd, "translator.backbone_adapter.1", params["backbone_adapter"]["adapter_1"])
    if translator in ("transformer", "trans"):
        sd.update(_stem(params, target_feature_sizes))
    for t, size in target_feature_sizes.items():
        head = params[f"head_{legit_name(t)}"]
        hp = f"translator.translator_heads.{head_key(t)}."
        if "_cls" in t or translator in ("mlp", "transformer", "trans"):  # Linears only
            for sub in head:
                _linear(sd, hp + sub.replace("_", "."), head[sub])
            continue
        s_eff = backbone_spatial
        if "pad" in head:
            sd[hp + "pad.1.weight"] = np.asarray(head["pad"]["pad_1"]["kernel"]).transpose(2, 3, 0, 1)
            sd[hp + "pad.1.bias"] = np.asarray(head["pad"]["pad_1"]["bias"])
            s_eff = 16
        # the conv head's ladder up (16 -> 64) is ConvTranspose at 1, 4 and 7;
        # the lconv head's at 1 and 4, its 8 (or 5) a Linear
        deconv_ladder = s_eff < size[1] if translator == "conv" else (s_eff == 16 and size[1] == 64)
        for idx in (0, 3, 6):  # LayerNormSpatial: (C,H,W) kept verbatim
            if f"adapter_{idx}" in head:
                sd[hp + f"adapter.{idx}.weight"] = np.asarray(head[f"adapter_{idx}"]["weight"])
                sd[hp + f"adapter.{idx}.bias"] = np.asarray(head[f"adapter_{idx}"]["bias"])
        for idx in (1, 4, 7):  # HWIO -> ConvTranspose2d (I,O,kh,kw) or Conv2d (O,I,kh,kw)
            if f"adapter_{idx}" in head:
                k = np.asarray(head[f"adapter_{idx}"]["kernel"])
                sd[hp + f"adapter.{idx}.weight"] = k.transpose(2, 3, 0, 1) if deconv_ladder else k.transpose(3, 2, 0, 1)
                sd[hp + f"adapter.{idx}.bias"] = np.asarray(head[f"adapter_{idx}"]["bias"])
        for idx in (5, 8):  # the lconv head's final Linear
            if f"adapter_{idx}" in head:
                _linear(sd, hp + f"adapter.{idx}", head[f"adapter_{idx}"])
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
    translator: str = "lconv",
) -> dict[str, torch.Tensor]:
    """JAX ``Theia`` params ({"backbone_module", "translator_module"}) -> state dict.

    ``backbone_spatial`` is the backbone's token grid side (14 at 224 px);
    ``translator`` the translator type ("lconv", "mlp", "conv", "transformer").
    """
    sd = _backbone(params["backbone_module"], variant, prefix="backbone.model.")
    if target_feature_sizes:
        sd.update(_translator(params["translator_module"], target_feature_sizes, backbone_spatial, translator))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in sd.items()}


def sam_decoder_state_dict(params: Mapping[str, Any], cfg: Any = None) -> dict[str, torch.Tensor]:
    """JAX ``SamMaskDecoder`` params -> the port's (HF ``SamModel``, less its
    vision encoder) state dict: the inverse of the JAX package's
    ``convert_sam_decoder`` (``theia_tpu/foundation/sam_decoder.py:258-306``).
    The prompt encoder's mask embedding, which the JAX module does not have
    (the no-mask path never runs it), gets zero weights and unit norms.
    ``cfg`` is the decoder's ``SamDecoderConfig`` (the full SAM's by default)."""
    from theia_tpu_torch.foundation.sam_decoder import SAM_DECODER

    cfg = cfg or SAM_DECODER
    c, m = cfg.hidden_size, cfg.mask_input_channels
    pe = np.asarray(params["positional_embedding"])
    point = np.asarray(params["point_embed"])
    sd: dict[str, np.ndarray] = {
        "shared_image_embedding.positional_embedding": pe,
        "prompt_encoder.shared_embedding.positional_embedding": pe,
        **{f"prompt_encoder.point_embed.{i}.weight": point[i: i + 1] for i in range(4)},
        "prompt_encoder.not_a_point_embed.weight": np.asarray(params["not_a_point_embed"]),
        "prompt_encoder.no_mask_embed.weight": np.asarray(params["no_mask_embed"]),
        "mask_decoder.iou_token.weight": np.asarray(params["iou_token"]),
        "mask_decoder.mask_tokens.weight": np.asarray(params["mask_tokens"]),
        # a transposed conv's (kh, kw, in, out) -> ConvTranspose2d (in, out, kh, kw)
        "mask_decoder.upscale_conv1.weight": np.asarray(params["upscale_conv1"]).transpose(2, 3, 0, 1),
        "mask_decoder.upscale_conv1.bias": np.asarray(params["upscale_conv1_bias"]),
        "mask_decoder.upscale_conv2.weight": np.asarray(params["upscale_conv2"]).transpose(2, 3, 0, 1),
        "mask_decoder.upscale_conv2.bias": np.asarray(params["upscale_conv2_bias"]),
        "mask_decoder.upscale_layer_norm.weight": np.asarray(params["upscale_ln"]),
        "mask_decoder.upscale_layer_norm.bias": np.asarray(params["upscale_ln_bias"]),
    }
    me = "prompt_encoder.mask_embed."
    for name, shape in (("conv1", (m // 4, 1, 2, 2)), ("conv2", (m, m // 4, 2, 2)), ("conv3", (c, m, 1, 1))):
        sd[me + name + ".weight"] = np.zeros(shape, np.float32)
        sd[me + name + ".bias"] = np.zeros(shape[0], np.float32)
    for name, n in (("layer_norm1", m // 4), ("layer_norm2", m)):
        sd[me + name + ".weight"], sd[me + name + ".bias"] = np.ones(n, np.float32), np.zeros(n, np.float32)
    tp = "mask_decoder.transformer."
    for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, f"{tp}final_attn_token_to_image.{k}", params["final_attn_token_to_image"][k])
    _norm(sd, tp + "layer_norm_final_attn", params["layer_norm_final_attn"])
    for dst, src in (("proj_in", "in"), ("layers.0", "mid"), ("proj_out", "out")):
        _linear(sd, f"mask_decoder.iou_prediction_head.{dst}", params[f"iou_{src}"])
        for i in range(cfg.num_mask_tokens):
            _linear(sd, f"mask_decoder.output_hypernetworks_mlps.{i}.{dst}", params[f"hyper_{i}_{src}"])
    for i in range(cfg.num_layers):
        layer, lp = params[f"layer_{i}"], f"{tp}layers.{i}."
        for attn in ("self_attn", "cross_attn_token_to_image", "cross_attn_image_to_token"):
            for k in ("q_proj", "k_proj", "v_proj", "out_proj"):
                _linear(sd, f"{lp}{attn}.{k}", layer[attn][k])
        for j in range(1, 5):
            _norm(sd, f"{lp}layer_norm{j}", layer[f"layer_norm{j}"])
        _linear(sd, lp + "mlp.lin1", layer["mlp_lin1"])
        _linear(sd, lp + "mlp.lin2", layer["mlp_lin2"])
    return _tensors(sd)


def policy_state_dict(params: Mapping[str, Any], log_std: Any = None) -> dict[str, torch.Tensor]:
    """JAX CortexBench head params (``ConvBatchNormMLP``, ``ConvPolicyHead``,
    the TriFinger ``ConvBatchNormMLPDeterministicPolicy``; with or without
    the ``{"params": ...}`` wrapper) -> the port module's state dict: the
    submodules carry the flax names, a conv's HWIO kernel becomes
    (O, I, kh, kw), a dense kernel is transposed, LayerNorm affines are
    kept. ``ConvBatchNormMLP``'s ``log_std`` (a flax param made only when
    its ``log_std`` method runs) becomes ``log_std_param``; where the params
    lack it, ``log_std`` gives it (the JAX init fills ``init_log_std``)."""
    params = params.get("params", params)
    sd: dict[str, np.ndarray] = {}
    for name, leaf in params.items():
        if name == "log_std":
            sd["log_std_param"] = np.asarray(leaf)
        elif "kernel" in leaf:
            k = np.asarray(leaf["kernel"])
            sd[f"{name}.weight"] = _hwio_to_oihw(k) if k.ndim == 4 else k.T
            sd[f"{name}.bias"] = np.asarray(leaf["bias"])
        else:
            _norm(sd, name, leaf)
    if "log_std_param" not in sd and log_std is not None:
        sd["log_std_param"] = np.asarray(log_std, np.float32)
    return _tensors(sd)
