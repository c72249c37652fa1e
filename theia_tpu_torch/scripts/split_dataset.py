"""Shard-level train/val/test split by filename rename + splits.json (a copy of
theia_tpu/scripts/split_dataset.py; the dataset lists are the port's copies)
(reference: src/theia/scripts/preprocessing/split_dataset.py:13-103):
0.8/0.05/0.15 over lexically-sorted shards, step counts recorded.

Usage:
    python -m theia_tpu_torch.scripts.split_dataset --dataset-root /data/theia \
        [--datasets ego4d ssv2] [--dry-run]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tarfile
from collections import OrderedDict

DATASET_RATIOS = OrderedDict({"train": 0.8, "val": 0.05, "test": 0.15})


def count_steps(tar_path: str) -> int:
    with tarfile.open(tar_path) as tarf:
        return len({x.name.split(".")[0] for x in tarf.getmembers()})


def do_dataset_split(dataset_root: str, dataset_name: str,
                     samples_per_shard: int = 1000, dry_run: bool = False) -> None:
    dataset_dir = os.path.join(dataset_root, dataset_name)
    split_json_file = os.path.join(dataset_dir, "splits.json")
    if os.path.exists(split_json_file):
        return

    shard_dir = os.path.join(dataset_dir, "images")
    shard_names = sorted(
        f for f in os.listdir(shard_dir) if f.endswith(".tar") and "-" in f
    )
    n_shards = len(shard_names)
    print(f"{dataset_name} total {n_shards} shards")

    cum = 0
    split_steps: dict[str, int] = {}
    for split, ratio in DATASET_RATIOS.items():
        split_n = math.ceil(n_shards * ratio)
        split_steps[split] = 0
        for idx in range(cum, min(cum + split_n, n_shards)):
            original = os.path.join(shard_dir, shard_names[idx])
            if idx == n_shards - 1:
                split_steps[split] += count_steps(original)
            else:
                split_steps[split] += samples_per_shard
            renamed = os.path.join(
                shard_dir, shard_names[idx].replace(".tar", f"-{split}.tar")
            )
            if not dry_run:
                os.rename(original, renamed)
        cum += split_n

    if not dry_run:
        with open(split_json_file, "w") as f:
            json.dump(split_steps, f, indent=4)
    print(split_steps)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--datasets", nargs="*", default=None)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--samples-per-shard", type=int, default=1000)
    args = parser.parse_args(argv)

    datasets = args.datasets
    if datasets is None:
        from theia_tpu_torch.data.oxe import ALL_OXE_DATASETS
        from theia_tpu_torch.data.registries import ALL_VIDEO_DATASETS

        datasets = []
        for d in list(ALL_OXE_DATASETS) + list(ALL_VIDEO_DATASETS):
            if "_sim" in d or "uiuc_d3field" in d or "cmu_playing_with_food" in d or "robot_vqa" in d:
                continue
            datasets.append(d)
    for dataset in datasets:
        if os.path.isdir(os.path.join(args.dataset_root, dataset)):
            do_dataset_split(args.dataset_root, dataset, args.samples_per_shard, args.dry_run)


if __name__ == "__main__":
    main()
