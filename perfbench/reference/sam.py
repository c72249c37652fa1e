"""A plain PyTorch SAM ViT image encoder: the benchmark's reference for SAM's configurations.

Written from the published encoder (Segment Anything, arXiv:2304.02643; its
window and global attention from ViTDet, arXiv:2203.16527; the decomposed
relative position from MViTv2, arXiv:2112.01526) as HF transformers'
``SamVisionEncoder`` and ``SamImageProcessor`` lay it out, over a flat dict
of tensors keyed by HF's state-dict names. It imports nothing of the program
under test. Every product runs in float32 with TF32 off unless ``precision``
is "tf32" (the control: TF32 matmuls and convolutions).

  - the processor: bilinear resize to the encoder's size (PIL's filter, the
    image rounded to uint8 after each pass, horizontal first), rescale by
    1/255, ImageNet normalisation; square inputs need no padding;
  - the encoder: 16x16 patch embedding with bias, absolute position
    embedding, then per layer: LayerNorm, window partition (zero padding on
    the bottom and right to a multiple of the window) unless the layer is
    global, attention with decomposed relative-position bias, window
    unpartition and crop, residual; LayerNorm, MLP with exact GELU,
    residual;
  - the neck: 1x1 convolution, channel LayerNorm, 3x3 convolution, channel
    LayerNorm, all convolutions without bias: [B, 256, 64, 64] at SAM-H's
    sizes, and its nearest-neighbour 32x32 copy.
Each departure from HF is a comment where it is made.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference.model import precision_flags  # noqa: F401 (the drivers take it from here)

# float32 scores of one block of query rows, in bytes: a global layer's
# whole score tensor at 32 images is 32 GiB
SCORE_BLOCK_BYTES = 1 << 30


# ---------------------------------------------------------------- parameters


def _sizes(cfg: dict) -> tuple[int, int, int, int]:
    """(hidden, heads' width, grid side, window side)."""
    c = cfg["hidden_size"]
    return c, c // cfg["num_attention_heads"], cfg["image_size"] // cfg["patch_size"], cfg["window_size"]


def param_spec(cfg: dict) -> list[tuple[str, tuple, str, float]]:
    """(HF state-dict name, shape, distribution, scale) of every parameter:
    "normal" is scale·N(0, 1), "one_plus" 1 + scale·N(0, 1). HF initialises
    the position embedding and the relative-position tables to 0 and the
    LayerNorms to 1 and 0; here each is drawn, so that each takes part in
    the check (``assumed`` in the configuration file says how)."""
    c, hd, g, w = _sizes(cfg)
    f, p, oc = cfg["mlp_dim"], cfg["patch_size"], cfg["output_channels"]
    rel = cfg["rel_pos_std"]

    def layer_norm(name: str, n: int) -> list:
        return [(name + ".weight", (n,), "one_plus", 0.1), (name + ".bias", (n,), "normal", 0.02)]

    def dense(name: str, out: int, inp: int) -> list:
        return [(name + ".weight", (out, inp), "normal", 0.02), (name + ".bias", (out,), "normal", 0.02)]

    spec = [
        ("patch_embed.projection.weight", (c, cfg["num_channels"], p, p), "normal", 0.02),
        ("patch_embed.projection.bias", (c,), "normal", 0.02),
        ("pos_embed", (1, g, g, c), "normal", 0.02),
    ]
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        size = g if i in cfg["global_attn_indexes"] else w
        spec += layer_norm(pre + "layer_norm1", c)
        spec += [(pre + "attn.rel_pos_h", (2 * size - 1, hd), "normal", rel),
                 (pre + "attn.rel_pos_w", (2 * size - 1, hd), "normal", rel)]
        spec += dense(pre + "attn.qkv", 3 * c, c) + dense(pre + "attn.proj", c, c)
        spec += layer_norm(pre + "layer_norm2", c)
        spec += dense(pre + "mlp.lin1", f, c) + dense(pre + "mlp.lin2", c, f)
    spec += [("neck.conv1.weight", (oc, c, 1, 1), "normal", 0.02)] + layer_norm("neck.layer_norm1", oc)
    spec += [("neck.conv2.weight", (oc, oc, 3, 3), "normal", 0.02)] + layer_norm("neck.layer_norm2", oc)
    return spec


def make_params(cfg: dict, generator: torch.Generator) -> dict[str, torch.Tensor]:
    """Every parameter drawn from ``generator`` on its device in float32, in
    two large draws (normal, the LayerNorm weights' normal), each leaf then
    a contiguous copy of its slice."""
    spec = param_spec(cfg)
    device = generator.device
    pools = {kind: torch.randn(sum(math.prod(s) for _, s, k, _ in spec if k == kind), generator=generator,
                               device=device) for kind in ("normal", "one_plus")}
    offsets = dict.fromkeys(pools, 0)
    out = {}
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        chunk = pools[kind][offsets[kind]:offsets[kind] + n].view(shape)
        offsets[kind] += n
        out[name] = chunk * scale + 1.0 if kind == "one_plus" else chunk * scale
    return out


# ---------------------------------------------------------------- the processor


def bilinear_matrix(in_size: int, out_size: int) -> np.ndarray:
    """PIL's bilinear resampling as an (out, in) matrix: output x takes the
    input pixels whose centres lie within 1 (the triangle's support, stretched
    by in/out when shrinking) of its centre (x + 0.5)·in/out, weighted by
    the triangle and normalised over the pixels that exist. PIL holds the
    weights in 22-bit fixed point and rounds half up; here they are float32
    and the caller rounds half to even: the two differ only where a pass lands
    within 2^-22 of a half."""
    scale = in_size / out_size
    stretch = max(scale, 1.0)
    support = stretch
    mat = np.zeros((out_size, in_size), dtype=np.float64)
    for x in range(out_size):
        centre = (x + 0.5) * scale
        lo = max(int(centre - support + 0.5), 0)
        hi = min(int(centre + support + 0.5), in_size)
        j = np.arange(lo, hi)
        wts = np.clip(1.0 - np.abs((j + 0.5 - centre) / stretch), 0.0, None)
        mat[x, lo:hi] = wts / wts.sum()
    return mat.astype(np.float32)


def preprocess(images: torch.Tensor, cfg: dict) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> normalised float32 [B, 3, S, S], S the encoder's image size."""
    x = images.permute(0, 3, 1, 2).float()
    size = cfg["image_size"]
    mh = torch.from_numpy(bilinear_matrix(x.shape[-2], size)).to(x.device)
    mw = torch.from_numpy(bilinear_matrix(x.shape[-1], size)).to(x.device)
    x = torch.matmul(x, mw.T).round().clamp(0, 255)  # horizontal pass, to uint8
    x = torch.matmul(mh, x).round().clamp(0, 255)  # vertical pass, to uint8
    mean = torch.tensor(cfg["image_mean"], device=x.device).view(1, 3, 1, 1)
    std = torch.tensor(cfg["image_std"], device=x.device).view(1, 3, 1, 1)
    return (x / 255.0 - mean) / std


# ---------------------------------------------------------------- the encoder


def _rel_index(size: int, device: torch.device) -> torch.Tensor:
    """HF ``get_rel_pos`` for equal query and key sizes: row i - j + size - 1 of the table."""
    i = torch.arange(size, device=device)
    return i[:, None] - i[None, :] + size - 1


def attention(p: dict, pre: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """HF ``SamVisionAttention`` with ``use_rel_pos`` over [B', S, S, C] -> [B', S, S, C]."""
    b, s, _, c = x.shape
    t, hd = s * s, c // heads
    qkv = F.linear(x, p[pre + "qkv.weight"], p[pre + "qkv.bias"]).reshape(b, t, 3, heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = qkv.reshape(3, b * heads, t, hd).unbind(0)
    idx = _rel_index(s, x.device)
    rh, rw = p[pre + "rel_pos_h"][idx], p[pre + "rel_pos_w"][idx]  # (S, S, hd)
    rq = q.reshape(b * heads, s, s, hd)
    rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)  # [B'H, qy, qx, ky]
    rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)  # [B'H, qy, qx, kx]
    rows = max(1, min(t, SCORE_BLOCK_BYTES // (b * heads * t * 4)))
    out = torch.empty_like(q)
    # HF forms every score at once; here in blocks of query rows (rows are
    # independent) so that a global layer at 32 images fits the card
    for r0 in range(0, t, rows):
        r1 = min(t, r0 + rows)
        scores = torch.matmul(q[:, r0:r1] * hd ** -0.5, k.transpose(-1, -2)).view(b * heads, r1 - r0, s, s)
        bias_h = rel_h.reshape(b * heads, t, s)[:, r0:r1]  # query rows r0 .. r1 - 1, (qy, qx) flattened
        bias_w = rel_w.reshape(b * heads, t, s)[:, r0:r1]
        scores = scores + bias_h[:, :, :, None] + bias_w[:, :, None, :]
        probs = torch.softmax(scores.view(b * heads, r1 - r0, t), dim=-1)
        out[:, r0:r1] = torch.matmul(probs, v)
    ctx = out.reshape(b, heads, s, s, hd).permute(0, 2, 3, 1, 4).reshape(b, s, s, c)
    return F.linear(ctx, p[pre + "proj.weight"], p[pre + "proj.bias"])


def _layer_norm(x: torch.Tensor, p: dict, name: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[name + ".weight"], p[name + ".bias"], eps)


def _channel_layer_norm(x: torch.Tensor, p: dict, name: str, eps: float) -> torch.Tensor:
    """HF ``SamLayerNorm`` over the channels of NCHW."""
    u = x.mean(1, keepdim=True)
    var = (x - u).pow(2).mean(1, keepdim=True)
    x = (x - u) / torch.sqrt(var + eps)
    return p[name + ".weight"][:, None, None] * x + p[name + ".bias"][:, None, None]


def encoder(p: dict, pixels: torch.Tensor, cfg: dict) -> torch.Tensor:
    """Normalised pixels [B, 3, S, S] -> the neck's output [B, 256, g, g]."""
    c, _, g, w = _sizes(cfg)
    heads, eps = cfg["num_attention_heads"], cfg["layer_norm_eps"]
    x = F.conv2d(pixels, p["patch_embed.projection.weight"], p["patch_embed.projection.bias"],
                 stride=cfg["patch_size"]).permute(0, 2, 3, 1)
    x = x + p["pos_embed"]
    b = x.shape[0]
    pad = (w - g % w) % w
    n = (g + pad) // w
    for i in range(cfg["num_hidden_layers"]):
        pre = f"layers.{i}."
        h = _layer_norm(x, p, pre + "layer_norm1", eps)
        if i in cfg["global_attn_indexes"]:
            h = attention(p, pre + "attn.", h, heads)
        else:
            h = F.pad(h, (0, 0, 0, pad, 0, pad))  # the padded tokens take part in the windows' attention
            h = h.reshape(b, n, w, n, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b * n * n, w, w, c)
            h = attention(p, pre + "attn.", h, heads)
            h = h.reshape(b, n, n, w, w, c).permute(0, 1, 3, 2, 4, 5).reshape(b, n * w, n * w, c)[:, :g, :g]
        x = x + h
        h = _layer_norm(x, p, pre + "layer_norm2", eps)
        h = F.linear(F.gelu(F.linear(h, p[pre + "mlp.lin1.weight"], p[pre + "mlp.lin1.bias"])),
                     p[pre + "mlp.lin2.weight"], p[pre + "mlp.lin2.bias"])
        x = x + h
    x = F.conv2d(x.permute(0, 3, 1, 2), p["neck.conv1.weight"])
    x = _channel_layer_norm(x, p, "neck.layer_norm1", eps)
    x = F.conv2d(x, p["neck.conv2.weight"], padding=1)
    return _channel_layer_norm(x, p, "neck.layer_norm2", eps)


def features(p: dict, images: torch.Tensor, cfg: dict, precision: str = "float32") -> tuple[torch.Tensor, torch.Tensor]:
    """uint8 [B, H, W, 3] -> (embedding [B, 256, g, g], its nearest 32x32 copy), float32."""
    with precision_flags(precision):
        emb = encoder(p, preprocess(images, cfg), cfg)
    return emb, F.interpolate(emb, size=(32, 32), mode="nearest")
