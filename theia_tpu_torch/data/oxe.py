"""Open-X-Embodiment dataset registry, mixes and frame-level datasets (port of theia_tpu/data/oxe.py).

The catalog (69 datasets with episode/step counts, camera keys and tfds
versions) and the named mixes are factual data mirrored from the reference
registries (reference: src/theia/dataset/oxe/oxe_common.py:16-430,
oxe_mixes.py:8-139), stored as oxe_catalog.json (a copy of the JAX
package's). The teacher list comes from the port's own
``foundation/common.py``, so nothing here reaches JAX.
"""

from __future__ import annotations

import glob
import json
import math
import os
from collections import OrderedDict
from typing import Any, Callable, Optional

import torch

from theia_tpu_torch.data.dataset import (RandomMix, _ZippedShardSet, get_frame_dataloader,
                                         normalize_ds_weights_by_ds_len, pad_shard_paths)
from theia_tpu_torch.data.webdataset import read_splits
from theia_tpu_torch.foundation.common import MODELS

_CATALOG_PATH = os.path.join(os.path.dirname(__file__), "oxe_catalog.json")
with open(_CATALOG_PATH) as _f:
    _CATALOG = json.load(_f)

ALL_OXE_DATASETS: dict[str, dict] = _CATALOG["datasets"]
OXE_NAMED_MIXES: dict[str, list[tuple[str, float]]] = {
    k: [(d, float(w)) for d, w in v] for k, v in _CATALOG["mixes"].items()
}


def oxe_dsname2path(dataset_name: str, version: Optional[str] = None) -> str:
    """Dataset name -> GCS tfds path (reference oxe_common.py:418-430)."""
    if version is None:
        version = ALL_OXE_DATASETS[dataset_name]["versions"][-1]
    return f"gs://gresearch/robotics/{dataset_name}/{version}"


def get_vo_keys(dataset_name: str, image_views: Optional[list | str | dict] = None) -> list[str]:
    """Visual-observation key selection (reference data_utils.py:52-82)."""
    default_keys = ALL_OXE_DATASETS[dataset_name]["visual_observation_keys"][:1]
    keys: list[str] = []
    if image_views is None:
        keys = default_keys
    elif isinstance(image_views, list):
        keys = ALL_OXE_DATASETS[dataset_name]["visual_observation_keys"]
    elif isinstance(image_views, str):
        all_keys = ALL_OXE_DATASETS[dataset_name]["visual_observation_keys"]
        if image_views == "static":
            keys = [k for k in all_keys if "wrist" not in k and "hand" not in k]
        elif image_views == "wrist":
            keys = [k for k in all_keys if "wrist" in k or "hand" in k]
    return keys or default_keys


def get_oxe_frame_dataset(
    dataset_root: str,
    dataset_mix: str | dict[str, float] | list = "oxe_magic_soup",
    feature_models: Optional[list[str]] = None,
    split: str = "train",
    dataset_ratio: float = 1.0,
    image_views: Optional[dict] = None,
    image_transform: Optional[Callable] = None,
    seed: int = 0,
    shuffle: bool = False,
    rank: int = 0,
    world_size: int = 1,
) -> tuple[Any, float]:
    """OXE frame-level dataset over per-view shard directories
    (reference data_utils.py:175-287). Shards live under
    <root>/<dataset>/<vo_key>[_<model>]/*-<split>*.tar with "packed" multi-
    feature shards sharing the view directory.

    Returns (iterable over merged sample dicts, expected length); batch it
    with ``data.dataset.get_frame_dataloader``."""
    packed_features = [m for m in MODELS if "llava" not in m]
    if isinstance(dataset_mix, str):
        if dataset_mix not in OXE_NAMED_MIXES:
            raise ValueError(f"unknown mix {dataset_mix}")
        mix = OrderedDict({k: v for k, v in OXE_NAMED_MIXES[dataset_mix]})
    elif isinstance(dataset_mix, dict):
        mix = OrderedDict(**dataset_mix)
    else:
        mix = OrderedDict({d: 1.0 for d in dataset_mix})
    if split in ("eval", "val"):
        mix = OrderedDict({d: 1.0 for d in mix})
    feature_models = feature_models or packed_features

    members, weights, lengths = [], [], []
    for dataset in mix:
        dataset_len = read_splits(os.path.join(dataset_root, dataset))[split]
        if dataset_len == 0:
            continue
        for vo_key in get_vo_keys(dataset, image_views):
            image_dir = os.path.join(dataset_root, dataset, vo_key)
            image_paths = sorted(glob.glob(os.path.join(image_dir, f"*-{split}*.tar")))
            if not image_paths:
                continue

            def _col(paths: list[str]) -> list[str]:
                return pad_shard_paths(paths, world_size)[rank::world_size]

            feature_shards = {}
            for m in feature_models:
                if m in packed_features:
                    # packed layout: features live in the same view shards
                    feature_shards[m] = _col(image_paths)
                else:
                    mdir = image_dir + f"_{m.replace('/', '_')}"
                    mpaths = sorted(glob.glob(os.path.join(mdir, f"*-{split}*.tar")))
                    feature_shards[m] = _col(mpaths)
            members.append(_ZippedShardSet(_col(image_paths), feature_shards, None, image_transform))
            weights.append(mix[dataset])
            lengths.append(math.ceil(dataset_len * dataset_ratio))

    norm_weights, expected = normalize_ds_weights_by_ds_len(weights, lengths)
    return RandomMix(members, probs=norm_weights, seed=seed), expected


def get_oxe_frame_dataloader(dataset: Any, batch_size: Optional[int] = None, shuffle_buffer_size: int = 1000,
                             **kwargs: Any) -> Any:
    """Loader over OXE frame datasets (reference data_utils.py:290-311); the
    datasets already yield merged sample dicts, so this is the generic frame
    loader."""
    return get_frame_dataloader(dataset, batch_size=batch_size, shuffle_buffer_size=shuffle_buffer_size, **kwargs)


def get_oxe_frame_iterator(loader: Any) -> Any:
    """(reference data_utils.py:314-339)"""
    return iter(loader)


def totensor(arr: Any) -> torch.Tensor:
    """The reference's only train-time image transform, ndarray to tensor
    (oxe_transforms.py:8-11)."""
    return torch.as_tensor(arr)
