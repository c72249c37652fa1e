"""Synthetic shard generation: stats-consistent fake teacher features (port of theia_tpu/data/synthetic.py).

The same shard layout, stats files and values for a seed as the JAX
function: the draws are its numpy ``RandomState`` stream, and float32 ->
bf16 rounds to nearest even in both, so the shards are byte for byte the
same. Used by tests and by ``chip_smoke.py``'s training-runtime phase.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from theia_tpu_torch.data.webdataset import ShardWriter, encode_image_npy, save_safetensors, write_splits


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


def generate_synthetic_dataset(
    root: str,
    dataset: str = "imagenet",
    feature_models: dict[str, tuple[int, int, int]] | None = None,
    n_train: int = 64,
    n_val: int = 16,
    samples_per_shard: int = 32,
    image_size: int = 224,
    with_cls: bool = True,
    seed: int = 0,
    write_stats: bool = True,
) -> str:
    """Create a webdataset-format dataset directory with random images and
    per-teacher features (+ float32 mean/std stats files)."""
    feature_models = feature_models or {
        "facebook/dinov2-large": (1024, 16, 16),
        "facebook/sam-vit-huge": (256, 64, 64),
    }
    rng = np.random.RandomState(seed)
    ddir = os.path.join(root, dataset)
    os.makedirs(os.path.join(ddir, "images"), exist_ok=True)

    for split, count in (("train", n_train), ("val", n_val)):
        n_shards = max(1, -(-count // samples_per_shard))
        idx = 0
        for si in range(n_shards):
            n_here = min(samples_per_shard, count - idx)
            keys = [f"{dataset}_{split}_{idx + j:06d}" for j in range(n_here)]
            img_path = os.path.join(ddir, "images", f"{dataset}-{si:06d}-{split}.tar")
            with ShardWriter(img_path) as w:
                for k in keys:
                    img = rng.randint(0, 256, (image_size, image_size, 3), np.uint8)
                    w.write(f"{k}.image", encode_image_npy(img))
            for model, (c, h, ww) in feature_models.items():
                mdir = os.path.join(ddir, model.replace("/", "_"))
                os.makedirs(mdir, exist_ok=True)
                path = os.path.join(mdir, f"{dataset}-{si:06d}-{split}.tar")
                with ShardWriter(path) as w:
                    for k in keys:
                        tensors = {"embedding": _bf16(rng.randn(c, h, ww))}
                        if with_cls:
                            tensors["cls_token"] = _bf16(rng.randn(c))
                        w.write(f"{k}.{model.replace('/', '_')}.safetensors", save_safetensors(tensors))
            idx += n_here
    write_splits(ddir, {"train": n_train, "val": n_val, "test": 0})

    if write_stats:
        for model, (c, _, _) in feature_models.items():
            name = model.replace("/", "_")
            np.save(os.path.join(root, f"imagenet_mean_{name}.npy"), np.zeros(c, np.float32))
            np.save(os.path.join(root, f"imagenet_var_{name}.npy"), np.ones(c, np.float32))
    return ddir
