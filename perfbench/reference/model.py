"""A plain PyTorch Theia with light-conv heads: the benchmark's reference.

Written from the published architecture (a DeiT backbone, HF ``ViTModel``
numerics; the reference ``RobotVisionFM``'s light-conv translator heads)
over a flat dict of tensors keyed by the reference's state-dict names. It
imports nothing of the program under test. Every product runs in float32
with TF32 off unless a ``precision`` asks for less:

  - "float32": the reference proper;
  - "tf32": the same with TF32 matmuls and convolutions, the control of a
    float32 configuration;
  - "fp8": computed in fp8 wherever the configuration computes in its
    bf16 compute dtype: every value the program holds in bf16 (products'
    operands and outputs, the residual stream, LayerNorm, softmax, GELU and
    head outputs) rounded to float8 e4m3 and its gradient to e5m2, each
    with a per-tensor scale; statistics and the loss stay float32, as the
    program keeps them. The control of a bf16 configuration;
  - "fp8_gemm": only the products in fp8 (operands e4m3, output gradients
    e5m2), everything else float32: what fp8 matrix products alone do.

Preprocessing is the DeiT processor's: bicubic resize (PIL's a = -0.5) to
``resize_size``, centre crop, rescale, normalise. ``pil_rounding`` rounds
to uint8 after each resize pass, horizontal first, as PIL does on a uint8
image (the plain serving path); without it the resize stays real-valued,
which is what the training recipe's fused embed computes.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator

import numpy as np
import torch
import torch.nn.functional as F

# The reference runs a batch in blocks of images, so that its float32
# activations fit once the program is freed. They grow with the width:
# Theia-Base (768) runs a train step in blocks of 32, Theia-Small (384) of 64.
BLOCK_WIDTH = 32 * 768


def block_rows(cfg: dict) -> int:
    """Images in one block of the reference, for every driver."""
    return max(1, BLOCK_WIDTH // cfg["hidden_size"])


# ---------------------------------------------------------------- parameters


def head_key(teacher: str) -> str:
    return teacher.replace(".", "_")


def _head_spec(cfg: dict, teacher: str, target: list[int]) -> list[tuple[str, tuple, str, float]]:
    c = cfg["hidden_size"]
    h = int(c * cfg.get("hidden_size_factor", 1.0))
    side = cfg["image_size"] // cfg["patch_size"]
    c_t, s_t = target[0], target[1]
    pre = f"translator.translator_heads.{head_key(teacher)}."
    spec = []
    if side < 16:
        spec += [(pre + "pad.1.weight", (c, c, 3, 3), "uniform", 1 / math.sqrt(c * 9)),
                 (pre + "pad.1.bias", (c,), "uniform", 1 / math.sqrt(c * 9))]
        side = 16
    if side == 16 and s_t == 64:
        maps = [(c, 16, 16), (h, 31, 31), (h, 64, 64)]
        convs = [(1, (c, h, 3, 3), h * 9, h), (4, (h, h, 3, 3), h * 9, h)]  # transposed: (I, O, k, k)
    elif side == s_t:
        maps = [(c, side, side), (h, side, side), (h, side, side)]
        convs = [(1, (h, c, 3, 3), c * 9, h), (4, (h, h, 3, 3), h * 9, h)]
    else:
        raise NotImplementedError(f"no light-conv head from {side}² to {s_t}²")
    for idx, shape in zip((0, 3, 6), maps):
        spec += [(pre + f"adapter.{idx}.weight", shape, "one_plus", 0.1),
                 (pre + f"adapter.{idx}.bias", shape, "normal", 0.02)]
    for idx, shape, fan_in, out in convs:
        spec += [(pre + f"adapter.{idx}.weight", shape, "uniform", 1 / math.sqrt(fan_in)),
                 (pre + f"adapter.{idx}.bias", (out,), "uniform", 1 / math.sqrt(fan_in))]
    spec += [(pre + "adapter.8.weight", (c_t, h), "uniform", 1 / math.sqrt(h)),
             (pre + "adapter.8.bias", (c_t,), "uniform", 1 / math.sqrt(h))]
    return spec


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(state-dict name, shape, distribution, scale) of every parameter:
    "normal" is scale·N(0, 1), "uniform" scale·U(-1, 1), "one_plus" 1 + scale·N(0, 1)."""
    c, f, p = cfg["hidden_size"], cfg["intermediate_size"], cfg["patch_size"]
    n = (cfg["image_size"] // p) ** 2
    pre = "backbone.model."
    spec = [
        (pre + "embeddings.cls_token", (1, 1, c), "normal", 0.02),
        (pre + "embeddings.position_embeddings", (1, 1 + n, c), "normal", 0.02),
        (pre + "embeddings.patch_embeddings.projection.weight", (c, 3, p, p), "normal", 0.02),
        (pre + "embeddings.patch_embeddings.projection.bias", (c,), "normal", 0.02),
    ]

    def layer_norm(name: str) -> list:
        return [(name + ".weight", (c,), "one_plus", 0.1), (name + ".bias", (c,), "normal", 0.02)]

    def dense(name: str, out: int, inp: int) -> list:
        return [(name + ".weight", (out, inp), "normal", 0.02), (name + ".bias", (out,), "normal", 0.02)]

    for i in range(cfg["num_hidden_layers"]):
        b = pre + f"encoder.layer.{i}."
        spec += layer_norm(b + "layernorm_before")
        for q in ("query", "key", "value"):
            spec += dense(b + f"attention.attention.{q}", c, c)
        spec += dense(b + "attention.output.dense", c, c)
        spec += layer_norm(b + "layernorm_after")
        spec += dense(b + "intermediate.dense", f, c)
        spec += dense(b + "output.dense", c, f)
    spec += layer_norm(pre + "layernorm")
    for t, size in cfg["teachers"].items():
        spec += _head_spec(cfg, t, size)
    return spec


def make_params(cfg: dict, generator: torch.Generator, dtype: torch.dtype = torch.float32) -> dict[str, torch.Tensor]:
    """Every parameter drawn from ``generator`` on its device, in three
    large draws (normal, uniform, the LayerNorm weights' normal), each
    leaf then a contiguous copy of its slice."""
    spec = param_spec(cfg)
    device = generator.device
    sizes = {kind: sum(math.prod(s) for _, s, k, _ in spec if k == kind) for kind in ("normal", "uniform", "one_plus")}
    pools = {
        "normal": torch.randn(sizes["normal"], generator=generator, device=device),
        "uniform": torch.rand(sizes["uniform"], generator=generator, device=device).mul_(2).sub_(1),
        "one_plus": torch.randn(sizes["one_plus"], generator=generator, device=device),
    }
    offsets = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        chunk = pools[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
        value = chunk * scale + 1.0 if kind == "one_plus" else chunk * scale
        out[name] = value.to(dtype)
    return out


# ---------------------------------------------------------------- precision


@contextlib.contextmanager
def precision_flags(precision: str) -> Iterator[None]:
    """TF32 off for "float32" and "fp8", on for "tf32"; restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    on = precision == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x rounded to an fp8 ``dtype`` with a per-tensor scale, back in x's dtype."""
    top = torch.finfo(dtype).max
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8Operand(torch.autograd.Function):
    """Forward: the operand in e4m3. Backward: the gradient straight through."""

    @staticmethod
    def forward(ctx, x):
        return _fp8(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _Fp8Grad(torch.autograd.Function):
    """Forward: unchanged. Backward: the gradient in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


class _Fp8Value(torch.autograd.Function):
    """Forward: the value in e4m3. Backward: its gradient in e5m2."""

    @staticmethod
    def forward(ctx, y):
        return _fp8(y, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g, torch.float8_e5m2)


def _q(x: torch.Tensor, precision: str) -> torch.Tensor:
    """An operand of a product as the precision holds it."""
    return _Fp8Operand.apply(x) if precision in ("fp8", "fp8_gemm") else x


def _g(y: torch.Tensor, precision: str) -> torch.Tensor:
    """A product's output: in fp8 with its gradient ("fp8"), or only its gradient ("fp8_gemm")."""
    if precision == "fp8":
        return _Fp8Value.apply(y)
    return _Fp8Grad.apply(y) if precision == "fp8_gemm" else y


def _a(y: torch.Tensor, precision: str) -> torch.Tensor:
    """Any other value the configuration holds in its compute dtype, and its gradient."""
    return _Fp8Value.apply(y) if precision == "fp8" else y


def _linear(x, w, b, precision):
    return _g(F.linear(_q(x, precision), _q(w, precision), b), precision)


# ---------------------------------------------------------------- preprocessing


def _cubic(x: np.ndarray, a: float) -> np.ndarray:
    ax = np.abs(x)
    return np.where(ax <= 1.0, (a + 2.0) * ax**3 - (a + 3.0) * ax**2 + 1.0,
                    np.where(ax < 2.0, a * ax**3 - 5.0 * a * ax**2 + 8.0 * a * ax - 4.0 * a, 0.0))


def resize_matrix(in_size: int, out_size: int, a: float = -0.5) -> np.ndarray:
    """(out, in) bicubic weights with half-pixel centres, taps clamped to
    the border and each row normalised (PIL's, for an enlargement)."""
    scale = out_size / in_size
    support = 2.0 / min(scale, 1.0)
    mat = np.zeros((out_size, in_size))
    for i in range(out_size):
        src = (i + 0.5) / scale - 0.5
        taps = np.floor(src - support).astype(np.int64) + np.arange(int(np.ceil(2 * support)) + 2)
        w = _cubic((src - taps) * min(scale, 1.0), a)
        w = w / w.sum()
        for t, wt in zip(np.clip(taps, 0, in_size - 1), w):
            mat[i, t] += wt
    return mat.astype(np.float32)


def preprocess(images: torch.Tensor, cfg: dict, pil_rounding: bool) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, 3, crop, crop]."""
    x = images.permute(0, 3, 1, 2).float()
    h, w = x.shape[-2:]
    r = cfg["resize_size"]
    mh = torch.from_numpy(resize_matrix(h, r)).to(x.device)
    mw = torch.from_numpy(resize_matrix(w, r)).to(x.device)
    if pil_rounding:
        x = torch.matmul(x, mw.T).round().clamp(0, 255)
        x = torch.matmul(mh, x).round().clamp(0, 255)
    else:
        x = torch.matmul(torch.matmul(mh, x), mw.T)
    top = (r - cfg["crop_size"]) // 2
    x = x[..., top:top + cfg["crop_size"], top:top + cfg["crop_size"]] / 255.0
    mean = torch.tensor(cfg["image_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["image_std"], device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


# ---------------------------------------------------------------- the model


def _layer_norm(x, p, name, eps):
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def backbone(p: dict, images: torch.Tensor, cfg: dict, *, pil_rounding: bool, tanh_gelu: bool,
             precision: str = "float32") -> torch.Tensor:
    """uint8 images -> the final LayerNorm's tokens [B, 1 + N, C] (CLS first)."""
    pre = "backbone.model."
    c, heads, eps = cfg["hidden_size"], cfg["num_attention_heads"], cfg["layer_norm_eps"]
    hd = c // heads
    x = preprocess(images, cfg, pil_rounding)
    w = p[pre + "embeddings.patch_embeddings.projection.weight"]
    tok = _g(F.conv2d(_q(x, precision), _q(w, precision), p[pre + "embeddings.patch_embeddings.projection.bias"],
                      stride=cfg["patch_size"]), precision)
    b = tok.shape[0]
    tok = tok.flatten(2).transpose(1, 2)
    x = _a(torch.cat([p[pre + "embeddings.cls_token"].expand(b, -1, -1), tok], 1)
           + p[pre + "embeddings.position_embeddings"], precision)
    t = x.shape[1]
    for i in range(cfg["num_hidden_layers"]):
        lp = pre + f"encoder.layer.{i}."
        h = _a(_layer_norm(x, p, lp + "layernorm_before", eps), precision)
        q, k, v = (_linear(h, p[lp + f"attention.attention.{n}.weight"], p[lp + f"attention.attention.{n}.bias"], precision)
                   .view(b, t, heads, hd).transpose(1, 2) for n in ("query", "key", "value"))
        scores = _g(torch.matmul(_q(q, precision), _q(k, precision).transpose(-1, -2)), precision) / math.sqrt(hd)
        probs = _a(scores.softmax(-1), precision)
        ctx = _g(torch.matmul(_q(probs, precision), _q(v, precision)), precision)
        ctx = ctx.transpose(1, 2).reshape(b, t, c)
        x = _a(x + _linear(ctx, p[lp + "attention.output.dense.weight"], p[lp + "attention.output.dense.bias"],
                           precision), precision)
        h = _a(_layer_norm(x, p, lp + "layernorm_after", eps), precision)
        h = _a(F.gelu(_linear(h, p[lp + "intermediate.dense.weight"], p[lp + "intermediate.dense.bias"], precision),
                      approximate="tanh" if tanh_gelu else "none"), precision)
        x = _a(x + _linear(h, p[lp + "output.dense.weight"], p[lp + "output.dense.bias"], precision), precision)
    return _a(_layer_norm(x, p, pre + "layernorm", eps), precision)


def _ln_spatial(x, weight, bias, eps):
    mean = x.mean(dim=(1, 2, 3), keepdim=True)
    var = (x - mean).square().mean(dim=(1, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def head(p: dict, tokens: torch.Tensor, cfg: dict, teacher: str, precision: str = "float32") -> torch.Tensor:
    """One teacher's light-conv head: patch tokens [B, N, C] -> [B, H_t·W_t, C_t]."""
    pre = f"translator.translator_heads.{head_key(teacher)}."
    eps = cfg["head_layer_norm_eps"]
    b, n, c = tokens.shape
    side = int(math.isqrt(n))
    x = tokens.reshape(b, side, side, c).permute(0, 3, 1, 2)
    if side < 16:
        x = _g(F.conv_transpose2d(_q(x, precision), _q(p[pre + "pad.1.weight"], precision), p[pre + "pad.1.bias"],
                                  stride=1, output_padding=14 - side), precision)
    up = cfg["teachers"][teacher][1] == 64
    for idx in (1, 4):
        x = _a(_ln_spatial(x, p[pre + f"adapter.{idx - 1}.weight"], p[pre + f"adapter.{idx - 1}.bias"], eps), precision)
        w, bias = _q(p[pre + f"adapter.{idx}.weight"], precision), p[pre + f"adapter.{idx}.bias"]
        if up:
            x = F.conv_transpose2d(_q(x, precision), w, bias, stride=2, padding=1 if idx == 1 else 0,
                                   output_padding=0 if idx == 1 else 1)
        else:
            x = F.conv2d(_q(x, precision), w, bias, padding=1)
        x = F.relu(_g(x, precision))
    x = _a(_ln_spatial(x, p[pre + "adapter.6.weight"], p[pre + "adapter.6.bias"], eps), precision)
    x = x.flatten(2).transpose(1, 2)
    return _linear(x, p[pre + "adapter.8.weight"], p[pre + "adapter.8.bias"], precision)


def forward_feature(p: dict, images: torch.Tensor, cfg: dict, precision: str = "float32") -> torch.Tensor:
    """The plain serving path: PIL-rounded preprocessing, exact GELU; the patch tokens."""
    return backbone(p, images, cfg, pil_rounding=True, tanh_gelu=False, precision=precision)[:, 1:]


def predict(p: dict, images: torch.Tensor, cfg: dict, *, fused: bool, tanh_gelu: bool,
            precision: str = "float32") -> dict[str, torch.Tensor]:
    """Every teacher's prediction [B, H·W, C_t]."""
    tokens = backbone(p, images, cfg, pil_rounding=not fused, tanh_gelu=tanh_gelu, precision=precision)[:, 1:]
    return {t: head(p, tokens, cfg, t, precision) for t in cfg["teachers"]}
