"""The port's offline extraction against the JAX package's, on the CPU.

Each teacher's key layout: the same synthetic image shards (224² uint8, the
port's ``generate_synthetic_dataset``, byte for byte the JAX one's) go
through the JAX ``extract_shard`` and the port's, on small towers carrying
the same weights (``models.convert``). The feature shards must hold the same
member names in the same order, the same keys, shapes and dtypes (bf16),
and values within one bf16 ulp (float32 sums in another order may round to
the neighbouring bf16 value), the ulp taken of the larger of the two values
and at no less than 2^-8 of the map's largest magnitude: those sums leave
~1e-7 of that magnitude on every value, which a value near 0 would count as
many of its own ulps.

The small towers' processors map the shards' 224² images to 224² (or, for
DINOv2, resize to 256 and crop 224), where the two packages' PIL-emulating
rounding agrees. Where a processor upsamples 224² by 1.5 (LLaVA's 336),
float32 sums in another order round ~0.03% of exact .5 ties the other way
(``test_torch_teachers.test_preprocess_resample_matches_jax``), and one
pixel a step apart moves every token of its image through attention: a
3-layer tower at 336 then differs beyond one ulp in ~1% of values (by one
ulp of the map's largest magnitude), so the LLaVA layout is held here at
224.

The round trip runs the port's ``main`` (weights read from a local HF-cache
layout, no ``transformers``), its resume skip, ``check_existing_shard``,
``check_shard``, ``compute_feature_stats`` (equal to the JAX script's: the
same float64 numpy over the same bf16 values) and the port's
``get_image_video_dataset`` over the shards.
"""

import dataclasses
import os
import shutil
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))

from test_torch_teachers import clip_pair, depth_cfg, dinov2_pair, init, perturb, sam_pair, vit_teacher_pair

from theia_tpu.data.webdataset import iter_samples as j_iter_samples
from theia_tpu.data.webdataset import load_safetensors_np
from theia_tpu.foundation import depth_anything as jda
from theia_tpu.foundation import extraction as jextraction
from theia_tpu.foundation import llava as jllava
from theia_tpu.foundation import towers as jtowers
from theia_tpu.foundation import vit as jfvit
from theia_tpu.scripts import calc_feature_mean as jcalc
from theia_tpu.scripts import feature_extraction as jfe
from theia_tpu_torch.foundation import extraction as textraction
from theia_tpu_torch.data import webdataset as twds
from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
from theia_tpu_torch.foundation import depth_anything as tda
from theia_tpu_torch.foundation import dinov2 as tdinov2
from theia_tpu_torch.foundation import towers as ttowers
from theia_tpu_torch.models import convert
from theia_tpu_torch.scripts import calc_feature_mean as tcalc
from theia_tpu_torch.scripts import check_feature as tcheck
from theia_tpu_torch.scripts import feature_extraction as tfe

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, patch_size=16, image_size=224)


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("extraction")
    generate_synthetic_dataset(str(root), feature_models={"x/y": (4, 4, 4)}, n_train=12, n_val=6,
                               samples_per_shard=6, write_stats=False)
    shutil.rmtree(root / "imagenet" / "x_y")
    return root


def depth_pair_224(seed=3):
    kw = depth_cfg(224)
    jm = jda.DepthAnything(jda.DepthAnythingConfig(**kw))
    params = perturb(init(jm, seed, 224), seed)
    tkw = dict(kw, backbone=ttowers.TowerConfig(**dataclasses.asdict(kw["backbone"])))
    tm = tda.get_depth_anything_model(state_dict=convert.depth_anything_state_dict(params), device="cpu",
                                      cfg=tda.DepthAnythingConfig(**tkw))
    return jm, params, tm


def teacher(name):
    """(JAX module, params, JAX feature fn, port module, port feature fn) of
    a small tower standing in for ``name``."""
    if "google/vit" in name:
        cfg = dataclasses.replace(jfvit.VIT_HUGE, hidden_size=160, num_layers=2, num_heads=2, intermediate_size=320)
        jm, params, tm = vit_teacher_pair(cfg, "linear")
    elif "sam" in name:
        jm, params, tm = sam_pair(image_size=224)  # 14x14 grid, windows of 4: padded to 16
    elif "clip" in name:
        jm, params, tm = clip_pair(jtowers.TowerConfig(**SMALL))
    elif "dinov2" in name:
        jm, params, tm = dinov2_pair(jtowers.TowerConfig(**SMALL, layer_norm_eps=1e-6, resize_size=256,
                                                         image_mean=jtowers.IMAGENET_MEAN,
                                                         image_std=jtowers.IMAGENET_STD))
    elif "llava" in name:
        jm, params, tm = clip_pair(dataclasses.replace(jllava.LLAVA_VISION, hidden_size=32, num_layers=3,
                                                       num_heads=2, intermediate_size=64, image_size=224,
                                                       resize_size=224, crop_size=224), seed=5)
    else:
        jm, params, tm = depth_pair_224()
    jfn = jextraction.get_model(name)[2]
    return jm, params, jfn, tm, textraction._lookup(name)[1]


def bf16_ulps(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    """|got - want| in bf16 ulps of the larger magnitude, floored at 2^-8 of
    ``want``'s largest."""
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)), np.abs(want).max() * 2.0 ** -8)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


LAYOUTS = {
    "google/vit-huge-patch14-224-in21k": {"google_vit-huge-patch14-224-in21k": {"cls_token": (160,),
                                                                                 "embedding": (160, 16, 16)}},
    "facebook/sam-vit-huge": {"facebook_sam-vit-huge": {"embedding": (8, 14, 14)}},
    "openai/clip-vit-large-patch14": {"openai_clip-vit-large-patch14": {
        "embedding": (64, 14, 14), "cls_token": (1, 64), "pooled_cls_token": (1, 64)}},
    "facebook/dinov2-large": {"facebook_dinov2-large": {
        "embedding": (64, 14, 14), "cls_token": (1, 64), "pooled_cls_token": (1, 64)}},
    "llava-hf/llava-1.5-7b-hf": {"llava-hf_llava-1.5-7b-hf": {"embedding": (32, 16, 16)}},
    "LiheYoung/depth-anything-large-hf": {"LiheYoung_depth-anything-large-hf": {"embedding": (8, 64, 64)}},
}


@pytest.mark.parametrize("name", list(LAYOUTS))
def test_extract_shard_matches_jax(name, image_root, tmp_path):
    jm, params, jfn, tm, tfn = teacher(name)
    legit = name.replace("/", "_")
    shard = tfe.iter_image_shards(str(image_root / "imagenet"), "train")[0]
    assert shard == jfe.iter_image_shards(str(image_root / "imagenet"), "train")[0]
    want_path, got_path = str(tmp_path / "jax.tar"), str(tmp_path / "port.tar")
    # batches of 4 over 6 samples: a full batch and a partial one
    jitted = jax.jit(lambda p, x: jfn(jm, p, x))
    assert jfe.extract_shard(shard, want_path, name, jm, params, lambda m, p, x: jitted(p, x), batch_size=4) == 6
    with torch.no_grad():
        assert tfe.extract_shard(shard, got_path, name, tm, tfn, batch_size=4) == 6
    want = list(j_iter_samples(want_path))
    got = list(twds.iter_samples(got_path))
    assert [k for k, _ in got] == [k for k, _ in want] and len(got) == 6
    ((member, shapes),) = LAYOUTS[name].items()
    for (_, gf), (_, wf) in zip(got, want):
        assert list(gf) == list(wf) == [f"{member}.safetensors"]
        g = twds.load_safetensors(gf[f"{member}.safetensors"])
        w = load_safetensors_np(wf[f"{member}.safetensors"])
        assert sorted(g) == sorted(w) == sorted(shapes)
        for key, shape in shapes.items():
            assert g[key].dtype == torch.bfloat16 and str(w[key].dtype) == "bfloat16"
            assert tuple(g[key].shape) == w[key].shape == shape
            ulps = bf16_ulps(g[key].float().numpy(), np.asarray(w[key], np.float32))
            assert ulps.max() <= 1, (key, float(ulps.max()))


def test_sam_feature_outputs_keep_the_32_map():
    """SAM's ``get_feature_outputs`` also writes ``_32``: the 64² map
    nearest-resized to 32², as the JAX function."""
    jm, params, jfn, tm, tfn = teacher("facebook/sam-vit-huge")
    imgs = np.random.default_rng(30).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    jitted = jax.jit(lambda p, x: jfn(jm, p, x))
    want = jextraction.get_feature_outputs("facebook/sam-vit-huge", jm, params, jnp.asarray(imgs),
                                           lambda m, p, x: jitted(p, x))
    got = textraction.get_feature_outputs("facebook/sam-vit-huge", tm, torch.from_numpy(imgs))
    assert sorted(got) == sorted(want) == ["facebook_sam-vit-huge", "facebook_sam-vit-huge_32"]
    w32 = np.asarray(want["facebook_sam-vit-huge_32"]["embedding"], np.float32)
    g32 = got["facebook_sam-vit-huge_32"]["embedding"]
    assert g32.dtype == torch.bfloat16 and tuple(g32.shape) == w32.shape == (2, 8, 32, 32)
    np.testing.assert_allclose(g32.float().numpy(), w32, rtol=2 ** -7, atol=1e-6)


def write_hf_cache(cache: Path, model_name: str, state_dict) -> None:
    """The local HF hub cache layout of one model with one safetensors file."""
    repo = cache / ("models--" + model_name.replace("/", "--"))
    (repo / "refs").mkdir(parents=True)
    (repo / "refs" / "main").write_text("0123abc")
    snap = repo / "snapshots" / "0123abc"
    snap.mkdir(parents=True)
    (snap / "model.safetensors").write_bytes(twds.save_safetensors(dict(state_dict)))


def test_extraction_round_trip(image_root, tmp_path, monkeypatch, capsys):
    name = "facebook/dinov2-large"
    legit = name.replace("/", "_")
    jm, params, jfn, tm, _ = teacher(name)
    root = tmp_path / "data"
    shutil.copytree(image_root, root)
    ddir = str(root / "imagenet")
    # the port's main on a small DINOv2 whose weights sit in a local HF cache
    monkeypatch.setattr(tdinov2, "DINOV2_LARGE", ttowers.TowerConfig(**dataclasses.asdict(tm.cfg)))
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    write_hf_cache(tmp_path / "hub", name, {f"{k}": v for k, v in tm.state_dict().items()})
    args = ["--dataset", "imagenet", "--model", name, "--dataset-root", str(root), "--batch-size", "4",
            "--device", "cpu"]
    for split in ("train", "val"):
        assert tfe.main(args + ["--split", split]) == {"train": 12, "val": 6}[split]
    out = capsys.readouterr().out
    assert "random init" not in out and out.count("done (6 samples)") == 3
    shards = tfe.iter_image_shards(ddir, "train")
    for shard in shards:
        ok, counts = twds.check_existing_shard(os.path.join(ddir, legit, os.path.basename(shard)), [legit])
        assert ok == 1 and counts[legit] == 6
    # the resume skip: complete shards are not regenerated
    mtimes = [os.path.getmtime(p) for p in sorted((root / "imagenet" / legit).glob("*.tar"))]
    assert tfe.main(args + ["--split", "train"]) == 0
    assert capsys.readouterr().out.count("check pass, skipping") == 2
    assert mtimes == [os.path.getmtime(p) for p in sorted((root / "imagenet" / legit).glob("*.tar"))]
    # rank 1 of 2 takes every second shard
    assert tfe.main(args + ["--split", "train", "--rank", "1", "--world-size", "2"]) == 0
    assert capsys.readouterr().out.count("check pass, skipping") == 1
    # what was written is the JAX extraction's to one bf16 ulp (layouts above), and regenerates bit-exactly
    assert tcheck.check_shard(ddir, name, 0, np.array([0, 3, 5]), "train", tm, None)
    # the stats equal the JAX script's on the same shards
    mean, std = tcalc.compute_feature_stats(os.path.join(ddir, legit))
    jmean, jstd = jcalc.compute_feature_stats(os.path.join(ddir, legit))
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)
    assert mean.shape == std.shape == (64,) and np.all(std > 0)
    np.save(root / f"imagenet_mean_{legit}.npy", mean)
    np.save(root / f"imagenet_var_{legit}.npy", std)
    # the port's training loader reads the shards
    from theia_tpu_torch.data.dataset import get_frame_dataloader, get_image_video_dataset

    ds, _ = get_image_video_dataset(dataset_root=str(root), feature_models=[name], dataset_mix=["imagenet"],
                                    split="train", feature_norm=True, stats_root=str(root), seed=0)
    batch = next(iter(get_frame_dataloader(ds, batch_size=4)))
    assert tuple(batch[name]["embedding"].shape) == (4, 196, 64)
    assert tuple(batch["image"].shape) == (4, 224, 224, 3)
    arr = batch[name]["embedding"].float()
    assert abs(float(arr.mean())) < 1.0 and 0.2 < float(arr.std()) < 5.0


def test_main_without_cached_weights_warns_and_inits(image_root, tmp_path, monkeypatch, capsys):
    """No cache entry: the JAX script's warning and a seeded random init
    (the same weights on a second call)."""
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "empty"))
    small = ttowers.TowerConfig(**SMALL, layer_norm_eps=1e-6, resize_size=256, image_mean=jtowers.IMAGENET_MEAN,
                                image_std=jtowers.IMAGENET_STD)
    monkeypatch.setattr(tdinov2, "DINOV2_LARGE", small)
    a, _ = tfe.build_teacher("facebook/dinov2-large", "cpu")
    b, _ = tfe.build_teacher("facebook/dinov2-large", "cpu")
    assert "WARNING: no pretrained weights for facebook/dinov2-large; using random init" in capsys.readouterr().out
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    assert tfe.main(["--dataset", "imagenet", "--model", "facebook/dinov2-large", "--dataset-root",
                     str(image_root), "--output-path", str(tmp_path / "out"), "--dry-run", "--device", "cpu"]) == 12
