"""The yardstick's arithmetic for SAM's configurations: the encoder's
forward FLOPs an image and K12's bytes and FLOPs a call, from the
configuration's shapes alone, by ``perfbench/flops.py``'s convention (a
model's FLOPs are its matrix products and convolutions, 2 a multiply-add;
a kernel's bytes read each input once and write each output once) and with
its ``Call`` and peaks."""

from __future__ import annotations

from perfbench import flops


def _shapes(cfg: dict) -> tuple[int, int, int, int, int]:
    """(hidden, grid side, window side, windows a side once padded, heads)."""
    g, w = cfg["image_size"] // cfg["patch_size"], cfg["window_size"]
    return cfg["hidden_size"], g, w, -(-g // w), cfg["num_attention_heads"]


def forward_flops_per_image(cfg: dict) -> float:
    """One image through the encoder: the patch embedding; per layer the QKV
    and output products over its tokens (a window layer's padded grid), the
    MLP over the grid, q·kᵀ and p·v, and the two relative-position products
    (each query against S rows of hd); the neck's two convolutions."""
    c, g, w, n, heads = _shapes(cfg)
    f, p, oc = cfg["mlp_dim"], cfg["patch_size"], cfg["output_channels"]
    hd = c // heads
    embed = 2.0 * g * g * c * cfg["num_channels"] * p * p
    mlp = 2.0 * g * g * 2 * c * f
    total = embed + 2.0 * g * g * c * oc + 2.0 * g * g * oc * oc * 9
    for i in range(cfg["num_hidden_layers"]):
        if i in cfg["global_attn_indexes"]:
            groups, side = 1, g
        else:
            groups, side = n * n, w
        t = side * side
        dense = 2.0 * groups * t * c * 4 * c
        attn = 4.0 * groups * t * t * c
        rel = 2 * 2.0 * groups * t * side * hd * heads
        total += dense + mlp + attn + rel
    return total


def relpos_attn_call(entries: int, side: int, heads: int, head_dim: int) -> flops.Call:
    """K12 over ``entries`` windows or images of side² tokens: reads q, k, v
    from the packed projection and writes the [entries, T, C] context, float32;
    4·entries·H·T²·hd FLOPs (q·kᵀ and p·v), bounded by the TF32 peak as K1's
    float32 calls are. The bias tables' products are cuBLAS's, outside the
    kernel, and their bytes are left out: the least traffic needs only q."""
    t = side * side
    c = heads * head_dim
    return flops.Call(4 * entries * t * c * 4, 4.0 * entries * heads * t * t * head_dim, "tf32")


def relpos_attn_batch_calls(cfg: dict, batch: int) -> list[flops.Call]:
    """K12's calls in one batch: one a layer."""
    c, g, w, n, heads = _shapes(cfg)
    window = relpos_attn_call(batch * n * n, w, heads, c // heads)
    whole = relpos_attn_call(batch, g, heads, c // heads)
    return [whole if i in cfg["global_attn_indexes"] else window for i in range(cfg["num_hidden_layers"])]
