"""The yardstick's arithmetic: model FLOPs from a configuration's shapes,
each hand-written kernel's bytes and FLOPs a call, and the card's peaks.

Counts follow the roofline convention of the benchmark: a model's FLOPs
are its matrix products and convolutions (2 a multiply-add), nothing else;
a kernel's bytes read each input once and write each output once, whatever
the kernel reads again; its FLOPs are the arithmetic the algorithm needs,
counted per element. Everything here is a pure function of the
configuration file (``perfbench/configs/<name>.json``), the batch and the
dtypes, so that a later change to the program cannot move the yardstick.
"""

from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): FLOP/s and bytes/s
PEAK_FLOPS = {"bfloat16": 989e12, "tf32": 495e12, "float32_fma": 67e12}
PEAK_BYTES_PER_S = 3.35e12

_BYTES = {"bfloat16": 2, "float32": 4}


def dtype_bytes(dtype: str) -> int:
    return _BYTES[dtype]


# ---------------------------------------------------------------- model FLOPs


def backbone_forward_flops(cfg: dict) -> float:
    """One image through the ViT backbone: the patch embed, and per layer
    the QKV, output and MLP products over every token plus q·kᵀ and p·v."""
    c, f, n = cfg["hidden_size"], cfg["intermediate_size"], cfg["num_hidden_layers"]
    side = cfg["image_size"] // cfg["patch_size"]
    patches = side * side
    tokens = patches + 1  # the CLS token
    embed = 2.0 * patches * c * 3 * cfg["patch_size"] ** 2
    dense = 2.0 * tokens * c * (3 * c + c + 2 * f)
    attn = 2.0 * 2.0 * tokens * tokens * c
    return embed + n * (dense + attn)


def _head_layers(cfg: dict, target: list[int]) -> list[tuple[str, int, int, int, int]]:
    """The light-conv head's products for one teacher: (kind, c_in, c_out,
    positions, taps) each, positions counted where a multiply-add happens:
    the output map of a convolution, the input map of a transposed one. A
    source under 16² is first padded to 16² by a 3x3 transposed convolution."""
    c = cfg["hidden_size"]
    h = int(c * cfg.get("hidden_size_factor", 1.0))
    side = cfg["image_size"] // cfg["patch_size"]
    c_t, s_t = target[0], target[1]
    layers = []
    if side < 16:
        layers.append(("convT", c, c, side * side, 9))
        side = 16
    if side == 16 and s_t == 64:
        return layers + [("convT", c, h, 16 * 16, 9), ("convT", h, h, 31 * 31, 9), ("dense", h, c_t, 64 * 64, 1)]
    if side == s_t:
        return layers + [("conv", c, h, side * side, 9), ("conv", h, h, side * side, 9),
                         ("dense", h, c_t, side * side, 1)]
    raise NotImplementedError(f"no FLOP count for a {side}² source and a {s_t}² target")


def heads_forward_flops(cfg: dict) -> float:
    """One image through every teacher's light-conv head."""
    return sum(2.0 * ci * co * pos * taps for t in cfg["teachers"].values() for _, ci, co, pos, taps in _head_layers(cfg, t))


def train_flops_per_image(cfg: dict) -> float:
    """A trained image: the forward of backbone and heads, three times
    (forward, the input gradient and the weight gradient; no recomputation)."""
    return 3.0 * (backbone_forward_flops(cfg) + heads_forward_flops(cfg))


def serve_flops_per_image(cfg: dict) -> float:
    """An image served by ``forward_feature``: the backbone's forward."""
    return backbone_forward_flops(cfg)


# ---------------------------------------------------------------- kernels


@dataclass(frozen=True)
class Call:
    """One kernel call: its bytes moved and FLOPs, the dtype whose peak
    bounds the FLOPs, and the device kernels it launches."""

    bytes: float
    flops: float
    peak: str
    launches: int = 1

    def bound_s(self) -> float:
        """The least time the card could take: max(bytes / bandwidth, FLOPs / peak)."""
        return max(self.bytes / PEAK_BYTES_PER_S, self.flops / PEAK_FLOPS[self.peak])


def ln_bwd_stats_call(b: int, c: int, h: int, w: int, dtype: str) -> Call:
    """K3 on a [B, C, H, W] map: reads x and g (``dtype``), the float32 (C, H, W)
    weight, the per-sample mean and r; writes float32 dw and db and the
    per-sample s1, s2. 9 FLOPs an element (x̂, g·w, the two sums, g·x̂ and g)."""
    n, s = b * c * h * w, c * h * w
    e = dtype_bytes(dtype)
    bytes_ = 2 * n * e + s * 4 + 2 * b * 4 + 2 * s * 4 + 2 * b * 4
    return Call(bytes_, 9.0 * n, "float32_fma")


def ln_bwd_dx_call(b: int, c: int, h: int, w: int, dtype: str) -> Call:
    """K4: reads x, g, the float32 weight and four per-sample scalars;
    writes dx in ``dtype``. 8 FLOPs an element."""
    n, s = b * c * h * w, c * h * w
    e = dtype_bytes(dtype)
    bytes_ = 3 * n * e + s * 4 + 4 * b * 4
    return Call(bytes_, 8.0 * n, "float32_fma")


def loss_sums_fwd_call(b: int, d: int, pred_dtype: str, target_dtype: str) -> Call:
    """K5 over [B, D] rows: reads pred and target once, writes five float32
    sums a row. 13 FLOPs an element (the difference, its square and smooth
    L1, p·t, p², t²). Two launches: the partial sums and their finish."""
    n = b * d
    return Call(n * (dtype_bytes(pred_dtype) + dtype_bytes(target_dtype)) + 5 * b * 4, 13.0 * n, "float32_fma", 2)


def loss_sums_bwd_call(b: int, d: int, pred_dtype: str, target_dtype: str) -> Call:
    """K6: reads pred, target and the five sums' cotangents a row, writes d
    pred. 10 FLOPs an element."""
    n = b * d
    e = dtype_bytes(pred_dtype)
    return Call(n * (2 * e + dtype_bytes(target_dtype)) + 5 * b * 4, 10.0 * n, "float32_fma")


def mha_fwd_call(b: int, t: int, heads: int, head_dim: int, dtype: str) -> Call:
    """K1 over a packed [B, T, 3C] projection: reads q, k, v, writes the
    [B, T, C] context; 4·B·H·T²·hd FLOPs (q·kᵀ and p·v). Float32 inputs are
    bounded by the TF32 tensor-core peak, the card's fastest rate for them."""
    c = heads * head_dim
    e = dtype_bytes(dtype)
    flops = 4.0 * b * heads * t * t * head_dim
    return Call(4 * b * t * c * e, flops, "bfloat16" if dtype == "bfloat16" else "tf32")


def ln_spatial_sites(cfg: dict) -> list[tuple[int, int, int]]:
    """The (C, H, W) of every LayerNormSpatial a light-conv step runs, one
    entry a call (each has one K3 and one K4 call in the backward)."""
    c = cfg["hidden_size"]
    h = int(c * cfg.get("hidden_size_factor", 1.0))
    side = cfg["image_size"] // cfg["patch_size"]
    side = max(side, 16)  # a smaller source is padded to 16² first
    sites = []
    for _, s_t, _ in cfg["teachers"].values():
        if side == 16 and s_t == 64:
            sites += [(c, 16, 16), (h, 31, 31), (h, 64, 64)]
        elif side == s_t:
            sites += [(c, side, side), (h, side, side), (h, side, side)]
        else:
            raise NotImplementedError(f"no LayerNormSpatial sites for a {side}² source and a {s_t}² target")
    return sites


def ln_bwd_step_calls(cfg: dict, batch: int, dtype: str) -> list[Call]:
    """K3 and K4's calls in one train step."""
    out = []
    for c, h, w in ln_spatial_sites(cfg):
        out += [ln_bwd_stats_call(batch, c, h, w, dtype), ln_bwd_dx_call(batch, c, h, w, dtype)]
    return out


def loss_step_calls(cfg: dict, batch: int, pred_dtype: str, target_dtype: str = "float32") -> list[Call]:
    """K5 and K6's calls in one train step: one each a teacher."""
    out = []
    for c, h, w in cfg["teachers"].values():
        d = c * h * w
        out += [loss_sums_fwd_call(batch, d, pred_dtype, target_dtype), loss_sums_bwd_call(batch, d, pred_dtype, target_dtype)]
    return out


def attn_fwd_batch_calls(cfg: dict, batch: int, dtype: str) -> list[Call]:
    """K1's calls in one ``forward_feature`` batch: one a layer."""
    side = cfg["image_size"] // cfg["patch_size"]
    heads = cfg["num_attention_heads"]
    call = mha_fwd_call(batch, side * side + 1, heads, cfg["hidden_size"] // heads, dtype)
    return [call] * cfg["num_hidden_layers"]
