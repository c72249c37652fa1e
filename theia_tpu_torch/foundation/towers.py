"""Teacher vision towers: CLIP vision and DINOv2 (port of theia_tpu/foundation/towers.py:26-208).

These are the ViT-variant encoders behind the teacher registry
(reference: src/theia/foundation_models/vision_language_models/clip.py,
vision_models/dinov2.py). The on-device processors reproduce the HF
processor configs:
  - CLIP: shortest-edge 224 bicubic -> crop 224 -> CLIP mean/std;
  - DINOv2: shortest-edge 256 bicubic -> crop 224 -> ImageNet mean/std.

The modules carry HF's parameter names (``CLIPVisionTransformer`` under
``vision_model.``, ``Dinov2Model``), so an HF state dict, its prefix
stripped, loads with ``strict=True``; ``models.convert`` carries the JAX
params across. Numerics are the JAX modules': ``dtype`` is the compute
dtype, parameters are cast to it at use, LayerNorms compute in float32, and
attention (``_attn``) is plain, float32 scores and softmax, as the JAX
package runs it outside Pallas.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from theia_tpu_torch.models.vit import layer_norm
from theia_tpu_torch.ops.image import preprocess_images

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


@dataclasses.dataclass(frozen=True)
class TowerConfig:
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    patch_size: int
    image_size: int
    layer_norm_eps: float = 1e-5
    # processor
    resize_size: int = 224
    crop_size: int = 224
    image_mean: tuple = CLIP_MEAN
    image_std: tuple = CLIP_STD
    resample: str = "cubic"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


CLIP_VIT_LARGE = TowerConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
    patch_size=14, image_size=224,
)
DINOV2_LARGE = TowerConfig(
    hidden_size=1024, num_layers=24, num_heads=16, intermediate_size=4096,
    patch_size=14, image_size=224, layer_norm_eps=1e-6,
    resize_size=256, image_mean=IMAGENET_MEAN, image_std=IMAGENET_STD,
)


def init_weights_(module: nn.Module, generator: Optional[torch.Generator] = None, std: float = 0.02) -> None:
    """Seeded random init of a teacher, on the device its parameters are on:
    LayerNorms (and SAM's channel LayerNorms) ones and zeros, biases zero,
    LayerScale ones, DINOv2's unused mask token zero, every other tensor
    trunc-normal(``std``). Walks parameters in a fixed order; ``generator``
    must be on the parameters' device."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            owner = module.get_submodule(name.rsplit(".", 1)[0]) if "." in name else module
            if isinstance(owner, (nn.LayerNorm, ChannelLayerNorm)):
                p.fill_(1.0 if leaf == "weight" else 0.0)
            elif leaf == "bias" or leaf == "mask_token":
                p.zero_()
            elif leaf == "lambda1":
                p.fill_(1.0)
            else:
                nn.init.trunc_normal_(p, std=std, generator=generator)


class ChannelLayerNorm(nn.Module):
    """LayerNorm over the last (channel) dim computed in float32, with the
    parameters ``weight`` and ``bias`` (HF ``SamLayerNorm``; the JAX
    ``_LayerNorm2d`` in channels-last)."""

    def __init__(self, features: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        y = (xf - mean) / torch.sqrt(var + self.eps)
        return (y * self.weight.float() + self.bias.float()).to(x.dtype)


def dense(m: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: kernel and bias cast to the compute dtype."""
    return F.linear(x, m.weight.to(dtype), None if m.bias is None else m.bias.to(dtype))


def _attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[B, T, C] q, k, v -> [B, T, C]: float32 scores and softmax, probabilities
    cast to v's dtype (the JAX ``_attn``'s einsum)."""
    b, t, c = q.shape
    hd = c // num_heads
    qh, kh, vh = (y.reshape(b, y.shape[1], num_heads, hd).transpose(1, 2) for y in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    probs = torch.softmax(scores / math.sqrt(hd), dim=-1).to(v.dtype)
    return torch.matmul(probs, vh).transpose(1, 2).reshape(b, t, c)


def channels_last(pixels: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Pixels already processed, NCHW or NHWC, as NHWC in ``dtype``."""
    x = pixels.to(dtype)
    return x.permute(0, 2, 3, 1) if x.shape[1] == 3 and x.shape[-1] != 3 else x


def to_pixels(images: torch.Tensor, cfg: TowerConfig, do_preprocess: bool, dtype: torch.dtype) -> torch.Tensor:
    """The tower's processor on uint8 images, or ``channels_last`` of pixels
    already processed; NHWC out."""
    if not do_preprocess:
        return channels_last(images, dtype)
    return preprocess_images(
        images, resize_size=cfg.resize_size, crop_size=cfg.crop_size,
        image_mean=cfg.image_mean, image_std=cfg.image_std, out_dtype=dtype, resample=cfg.resample,
    )


def patchify(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """NHWC pixels -> [B, N, C] by extract-patches and one matmul with the
    conv weight [C, 3, p, p] in the compute dtype (the JAX modules' dot)."""
    c, _, p, _ = weight.shape
    b, h, w, _ = x.shape
    nh, nw = h // p, w // p
    patches = x.permute(0, 3, 1, 2).reshape(b, 3, nh, p, nw, p).permute(0, 2, 4, 1, 3, 5).reshape(b, nh * nw, -1)
    return F.linear(patches, weight.reshape(c, -1).to(dtype), None if bias is None else bias.to(dtype))


class _CLIPLayer(nn.Module):
    def __init__(self, cfg: TowerConfig) -> None:
        super().__init__()
        c = cfg.hidden_size
        self.self_attn = nn.ModuleDict({n: nn.Linear(c, c) for n in ("k_proj", "v_proj", "q_proj", "out_proj")})
        self.layer_norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(c, cfg.intermediate_size), "fc2": nn.Linear(cfg.intermediate_size, c)})
        self.layer_norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, x: torch.Tensor, num_heads: int, dtype: torch.dtype) -> torch.Tensor:
        att = self.self_attn
        h = layer_norm(x, self.layer_norm1, dtype)
        a = _attn(dense(att["q_proj"], h, dtype), dense(att["k_proj"], h, dtype), dense(att["v_proj"], h, dtype),
                  num_heads)
        x = x + dense(att["out_proj"], a, dtype)
        h = dense(self.mlp["fc1"], layer_norm(x, self.layer_norm2, dtype), dtype)
        h = h * torch.sigmoid(1.702 * h)  # quick_gelu
        return x + dense(self.mlp["fc2"], h, dtype)


class CLIPVisionTower(nn.Module):
    """HF CLIPVisionModel numerics: pre-layernorm ViT with quick-gelu MLPs;
    returns (last_hidden_state [B,1+N,C], pooled = post_layernorm(cls)).
    Parameter names are ``CLIPVisionTransformer``'s."""

    def __init__(self, cfg: TowerConfig = CLIP_VIT_LARGE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = nn.Module()
        self.embeddings.class_embedding = nn.Parameter(torch.empty(c))
        self.embeddings.patch_embedding = nn.Conv2d(3, c, p, stride=p, bias=False)
        self.embeddings.position_embedding = nn.Embedding(1 + cfg.num_patches, c)
        self.pre_layrnorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.encoder = nn.ModuleDict({"layers": nn.ModuleList(_CLIPLayer(cfg) for _ in range(cfg.num_layers))})
        self.post_layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor, do_preprocess: bool = True, output_hidden_indices: tuple[int, ...] = ()):
        cfg, dt, emb = self.cfg, self.dtype, self.embeddings
        x = to_pixels(images, cfg, do_preprocess, dt)
        tokens = patchify(x, emb.patch_embedding.weight, None, dt)  # CLIP's patch conv has no bias
        cls = emb.class_embedding.to(dt).expand(tokens.shape[0], 1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + emb.position_embedding.weight[None].to(dt)
        tokens = layer_norm(tokens, self.pre_layrnorm, dt)
        hidden_states = [tokens]
        for layer in self.encoder["layers"]:
            tokens = layer(tokens, cfg.num_heads, dt)
            hidden_states.append(tokens)
        pooled = layer_norm(tokens[:, 0], self.post_layernorm, dt)
        if output_hidden_indices:
            return tokens, pooled, [hidden_states[i] for i in output_hidden_indices]
        return tokens, pooled


class _LayerScale(nn.Module):
    def __init__(self, c: int) -> None:
        super().__init__()
        self.lambda1 = nn.Parameter(torch.ones(c))


class _Dinov2Layer(nn.Module):
    def __init__(self, cfg: TowerConfig) -> None:
        super().__init__()
        c = cfg.hidden_size
        self.norm1 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.attention = nn.ModuleDict({
            "attention": nn.ModuleDict({n: nn.Linear(c, c) for n in ("query", "key", "value")}),
            "output": nn.ModuleDict({"dense": nn.Linear(c, c)}),
        })
        self.layer_scale1 = _LayerScale(c)
        self.norm2 = nn.LayerNorm(c, eps=cfg.layer_norm_eps)
        self.mlp = nn.ModuleDict({"fc1": nn.Linear(c, cfg.intermediate_size), "fc2": nn.Linear(cfg.intermediate_size, c)})
        self.layer_scale2 = _LayerScale(c)

    def forward(self, x: torch.Tensor, num_heads: int, dtype: torch.dtype) -> torch.Tensor:
        att = self.attention["attention"]
        h = layer_norm(x, self.norm1, dtype)
        a = _attn(dense(att["query"], h, dtype), dense(att["key"], h, dtype), dense(att["value"], h, dtype), num_heads)
        x = x + dense(self.attention["output"]["dense"], a, dtype) * self.layer_scale1.lambda1.to(dtype)
        h = F.gelu(dense(self.mlp["fc1"], layer_norm(x, self.norm2, dtype), dtype), approximate="none")
        return x + dense(self.mlp["fc2"], h, dtype) * self.layer_scale2.lambda1.to(dtype)


class Dinov2Tower(nn.Module):
    """HF Dinov2Model numerics: pre-LN ViT with LayerScale; returns
    (last_hidden_state = LN(h), pooled = LN(h)[:, 0]). Parameter names are
    ``Dinov2Model``'s (``embeddings.mask_token`` is kept, unused, so an HF
    state dict loads strictly)."""

    def __init__(self, cfg: TowerConfig = DINOV2_LARGE, dtype: torch.dtype = torch.float32) -> None:
        super().__init__()
        c, p = cfg.hidden_size, cfg.patch_size
        self.cfg = cfg
        self.dtype = dtype
        self.embeddings = nn.Module()
        self.embeddings.cls_token = nn.Parameter(torch.empty(1, 1, c))
        self.embeddings.mask_token = nn.Parameter(torch.zeros(1, c))
        self.embeddings.position_embeddings = nn.Parameter(torch.empty(1, 1 + cfg.num_patches, c))
        self.embeddings.patch_embeddings = nn.ModuleDict({"projection": nn.Conv2d(3, c, p, stride=p)})
        self.encoder = nn.ModuleDict({"layer": nn.ModuleList(_Dinov2Layer(cfg) for _ in range(cfg.num_layers))})
        self.layernorm = nn.LayerNorm(c, eps=cfg.layer_norm_eps)

    def forward(self, images: torch.Tensor, do_preprocess: bool = True, output_hidden_indices: tuple[int, ...] = ()):
        cfg, dt, emb = self.cfg, self.dtype, self.embeddings
        x = to_pixels(images, cfg, do_preprocess, dt)
        proj = emb.patch_embeddings["projection"]
        tokens = patchify(x, proj.weight, proj.bias, dt)
        cls = emb.cls_token.to(dt).expand(tokens.shape[0], -1, -1)
        tokens = torch.cat([cls, tokens], dim=1) + emb.position_embeddings.to(dt)
        hidden_states = [tokens]
        for layer in self.encoder["layer"]:
            tokens = layer(tokens, cfg.num_heads, dt)
            hidden_states.append(tokens)
        out = layer_norm(tokens, self.layernorm, dt)
        if output_hidden_indices:
            # HF Dinov2Backbone applies the shared final layernorm to each
            # selected stage; hidden_states[0] is the embedding output
            return out, out[:, 0], [layer_norm(hidden_states[i], self.layernorm, dt) for i in output_hidden_indices]
        return out, out[:, 0]


def build_tower(cls: type, cfg, dtype: torch.dtype, device, state_dict=None,
                generator: Optional[torch.Generator] = None) -> nn.Module:
    """A tower built on ``device`` in eval mode: ``state_dict`` (HF names,
    prefix stripped) loaded strictly, else a seeded random init there."""
    with torch.device(device):
        module = cls(cfg, dtype=dtype)
    if state_dict is not None:
        module.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()}, strict=True)
    else:
        init_weights_(module, generator)
    return module.eval().requires_grad_(False)


def strip_prefix(sd, prefix: str) -> dict:
    """``sd`` with ``prefix`` removed from its keys when any key carries it
    (only those keys kept then), as the JAX converters accept both forms."""
    if any(k.startswith(prefix) for k in sd):
        return {k.removeprefix(prefix): v for k, v in sd.items() if k.startswith(prefix)}
    return dict(sd)
