"""The port's SAM encoder against the benchmark's plain reference, on the CPU.

``perfbench/reference/sam.py`` is HF ``SamVisionEncoder``'s forward and
``SamImageProcessor``'s resize written in plain float32 torch, importing
nothing of the port. At a small size (hidden 64, 4 heads of 16, 4 layers,
global at [1, 3], image 128 from 56² uint8 images) on seeded weights in HF's
layout, loaded ``strict=True``:

  - the port's encoder through ``extract_batch`` (the float32 feature it
    casts, kept by a feature function passed in) agrees with the reference
    within 1e-5 (rel L2; float32 sums in another order leave ~1e-6), at
    window 3 (the 8² grid padded to 9²) and 4 (no padding); the bf16
    embedding it returns is that feature rounded, and the ``_32`` store the
    reference's nearest 32² copy rounded; with the relative-position tables
    zeroed in the reference alone the same comparison fails;
  - ``relpos_attention``'s CPU path (the plain version
    ``relpos_attention_plain``) equals K12's formula written out entry by
    entry: softmax(q.k * scale + rel_h[q, k // S] + rel_w[q, k % S]) v;
  - ``extract_shard`` writes, a sample, the rows of ``get_feature_outputs``'
    own store for its batch, in the shard's member order;
  - ``perfbench/sam_flops.py`` against counts by hand at SAM-H's shapes.
"""

from __future__ import annotations

import copy
import json
import math
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import sam_flops
from perfbench.reference import sam as ref
from theia_tpu_torch.data import webdataset as wds
from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
from theia_tpu_torch.foundation import sam as tsam
from theia_tpu_torch.foundation.extraction import extract_batch, get_feature_outputs
from theia_tpu_torch.ops import attention
from theia_tpu_torch.scripts.feature_extraction import extract_shard

ROOT = Path(__file__).resolve().parent.parent
NAME = "facebook/sam-vit-huge"
SAM_H = json.loads((ROOT / "perfbench" / "configs" / "sam-vit-huge.json").read_text())


def small(window: int) -> dict:
    return dict(copy.deepcopy(SAM_H), hidden_size=64, num_attention_heads=4, num_hidden_layers=4,
                global_attn_indexes=[1, 3], image_size=128, mlp_dim=256, output_channels=32, window_size=window)


def port(cfg: dict, params: dict) -> tsam.SamVisionEncoder:
    scfg = tsam.SamVisionConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["mlp_dim"], image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        window_size=cfg["window_size"], global_attn_indexes=tuple(cfg["global_attn_indexes"]),
        output_channels=cfg["output_channels"], layer_norm_eps=cfg["layer_norm_eps"])
    return tsam.get_sam_model(NAME, state_dict=params, device="cpu", cfg=scfg)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def through_extract_batch(cfg: dict, seed: int = 5):
    """(params, images, the float32 feature extract_batch cast, its bf16 samples)."""
    gen = torch.Generator().manual_seed(seed)
    params = ref.make_params(cfg, gen)
    images = torch.randint(0, 256, (3, 56, 56, 3), generator=gen, dtype=torch.uint8)
    kept = {}

    def feature_fn(module, x):
        out = tsam.get_sam_feature(module, x)
        kept["f32"] = out[0]
        return out

    samples = extract_batch(NAME, port(cfg, params), images, feature_fn)
    return params, images, kept["f32"], samples


@pytest.mark.parametrize("window", [3, 4], ids=["window3_padded", "window4"])
def test_encoder_through_extract_batch_matches_reference(window):
    cfg = small(window)
    params, images, f32, samples = through_extract_batch(cfg)
    with torch.no_grad():
        want, want32 = ref.features(params, images, cfg)
    assert f32.dtype == torch.float32 and f32.shape == want.shape == (3, 32, 8, 8)
    assert rel_l2(f32, want) < 1e-5
    emb = torch.stack([s["embedding"] for s in samples])
    assert list(samples[0]) == ["embedding"] and emb.dtype == torch.bfloat16
    assert torch.equal(emb, f32.to(torch.bfloat16))
    got32 = get_feature_outputs(NAME, port(cfg, params), images)[NAME.replace("/", "_") + "_32"]["embedding"]
    assert got32.shape == (3, 32, 32, 32)
    assert rel_l2(got32.float(), want32.to(torch.bfloat16).float()) < 1e-2  # one bf16 rounding apart at most


def test_dropping_the_bias_in_the_reference_fails_the_comparison():
    """The tables matter at this size: zeroed in the reference alone, the
    program's feature is far outside the 1e-5 it otherwise keeps."""
    cfg = small(3)
    params, images, f32, _ = through_extract_batch(cfg)
    zeroed = {k: torch.zeros_like(v) if "rel_pos" in k else v for k, v in params.items()}
    with torch.no_grad():
        want, _ = ref.features(zeroed, images, cfg)
    assert rel_l2(f32, want) > 1e-4


@pytest.mark.parametrize("side, heads, hd, entries", [(3, 2, 16, 5), (4, 4, 16, 3), (8, 2, 32, 2), (14, 2, 16, 2)])
def test_relpos_attention_cpu_path_equals_decomposed_attn(side, heads, hd, entries):
    gen = torch.Generator().manual_seed(side)
    c = heads * hd
    qkv = torch.randn(entries, side * side, 3 * c, generator=gen)
    rh = 0.5 * torch.randn(2 * side - 1, hd, generator=gen)
    rw = 0.5 * torch.randn(2 * side - 1, hd, generator=gen)
    got = attention.relpos_attention(qkv, rh, rw, heads, side)
    t = side * side
    q, k, v = qkv.view(entries, t, 3, heads, hd).permute(2, 0, 3, 1, 4).double()  # [B, H, T, hd] each
    qy, qx = torch.arange(t) // side, torch.arange(t) % side
    rel_h = torch.einsum("bhqd,qkd->bhqk", q, rh.double()[qy[:, None] - qy[None, :] + side - 1])
    rel_w = torch.einsum("bhqd,qkd->bhqk", q, rw.double()[qx[:, None] - qx[None, :] + side - 1])
    scores = q @ k.transpose(-1, -2) / math.sqrt(hd) + rel_h + rel_w
    want = (scores.softmax(-1) @ v).transpose(1, 2).reshape(entries, t, c).float()
    assert got.shape == want.shape == (entries, side * side, c)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_relpos_attention_refuses_a_grid_it_is_not_given():
    qkv = torch.zeros(1, 10, 3 * 32)
    with pytest.raises(ValueError):
        attention.relpos_attention(qkv, torch.zeros(5, 16), torch.zeros(5, 16), 2, 3)


def _members(path: str) -> list[tuple[str, bytes]]:
    with tarfile.open(path) as tar:
        return [(m.name, tar.extractfile(m).read()) for m in tar.getmembers()]


def test_extract_shard_store_layout_is_unchanged(tmp_path):
    generate_synthetic_dataset(str(tmp_path), feature_models={"x/y": (4, 4, 4)}, n_train=5, n_val=1,
                               samples_per_shard=5, image_size=56, write_stats=False)
    shard = sorted((tmp_path / "imagenet" / "images").glob("*-train.tar"))[0]
    cfg = small(3)
    module = port(cfg, ref.make_params(cfg, torch.Generator().manual_seed(9)))
    out = tmp_path / "out.tar"
    assert extract_shard(str(shard), str(out), NAME, module, tsam.get_sam_feature, batch_size=2) == 5
    samples = [(k, wds.decode_image_npy(f["image"])) for k, f in wds.iter_samples(str(shard))]
    legit = NAME.replace("/", "_")
    want = []
    for i in range(0, 5, 2):
        batch = samples[i:i + 2]
        feats = get_feature_outputs(NAME, module, torch.stack([b[1] for b in batch]))[legit]
        want += [(f"{key}.{legit}.safetensors", {k: v[j] for k, v in feats.items()}) for j, (key, _) in
                 enumerate(batch)]
    got = _members(str(out))
    assert [name for name, _ in got] == [name for name, _ in want]
    for (_, data), (_, tensors) in zip(got, want):
        assert data == wds.save_safetensors(tensors)
        loaded = wds.load_safetensors(data)
        assert list(loaded) == ["embedding"] and loaded["embedding"].shape == (32, 8, 8)
        assert loaded["embedding"].dtype == torch.bfloat16


def test_sam_h_flops_by_hand():
    """At SAM-H's published shapes: a window layer's QKV and output products
    run over the 70² padded grid (25 windows of 196), the MLP over 64²; a
    global layer's over 64²; q·kᵀ and p·v over each window or the grid; the
    rel-pos products, each query against S rows of 80; patch embed, neck."""
    c, f, t, tw = 1280, 5120, 4096, 196
    window = 2 * 25 * tw * c * 4 * c + 2 * t * c * 2 * f + 4 * 25 * tw ** 2 * c + 4 * 25 * tw * 14 * 80 * 16
    whole = 2 * t * c * 4 * c + 2 * t * c * 2 * f + 4 * t ** 2 * c + 4 * t * 64 * 80 * 16
    embed, neck = 2 * t * c * 3 * 256, 2 * t * c * 256 + 2 * t * 256 * 256 * 9
    assert sam_flops.forward_flops_per_image(SAM_H) == 28 * window + 4 * whole + embed + neck
    assert math.isclose(sam_flops.forward_flops_per_image(SAM_H), 5.961e12, rel_tol=1e-3)
    calls = sam_flops.relpos_attn_batch_calls(SAM_H, 32)
    assert len(calls) == 32 and [c_.flops for c_ in calls].count(4 * 32 * 16 * t ** 2 * 80) == 4
    win = calls[0]
    assert win.bytes == 4 * 800 * tw * 1280 * 4 and win.flops == 4 * 800 * 16 * tw ** 2 * 80
    assert math.isclose(win.bound_s(), win.bytes / 3.35e12)  # bytes bound a window call
    assert math.isclose(calls[7].bound_s(), calls[7].flops / 495e12)  # the TF32 peak a global one
    assert math.isclose(sum(c_.bound_s() for c_ in calls) * 1e3, 49.05, rel_tol=1e-3)


def test_reference_resize_is_pils_bilinear():
    """224 -> 1024 by PIL's rule: two taps whose weights are odd multiples of
    1/64 inside, the edge pixels alone at the borders."""
    m = ref.bilinear_matrix(224, 1024)
    assert np.allclose(m.sum(1), 1.0)
    assert m[0, 0] == 1.0 and m[-1, -1] == 1.0
    inner = m[4:-4]
    assert ((inner > 0).sum(1) == 2).all()
    assert np.all(np.isclose((inner[inner > 0] * 64) % 2, 1.0))
