"""Organize imagefolder-style images (ImageNet) into webdataset shards (a copy
of theia_tpu/scripts/organize_imagenet_webdataset.py, framework-free, writing
through the port's own data/webdataset.py)
(reference: src/theia/scripts/preprocessing/image_datasets/
organize_imagenet_webdataset.py:19-131): resize to 224x224, save npy-in-tar,
1000 samples/shard, resumable via shard integrity check.

Usage:
    python -m theia_tpu_torch.scripts.organize_imagenet_webdataset \
        --dataset imagenet --imagenet-raw-path /raw --output-path /data/theia \
        --split train [--samples-per-shard 1000]
"""

from __future__ import annotations

import argparse
import glob
import os
import shutil
import tarfile

import numpy as np


def check_existing_shard(path: str) -> bool:
    try:
        with tarfile.open(path) as tarf:
            for _ in tarf.getmembers():
                pass
    except (FileNotFoundError, ValueError, tarfile.ReadError, tarfile.CompressionError):
        return False
    return True


def _load_resized(image_path: str, size: int = 224) -> np.ndarray:
    from PIL import Image

    img = Image.open(image_path).convert("RGB").resize((size, size), Image.BILINEAR)
    return np.asarray(img)


def create_shard(dataset: str, shard_idx: int, shard_path: str | None,
                 remote_shard_path: str, frames: list[tuple[np.ndarray, str]]) -> None:
    from theia_tpu_torch.data.webdataset import ShardWriter, encode_image_npy

    if check_existing_shard(remote_shard_path):
        print(f"creating {dataset} shard {shard_idx:06d} - check pass, skip")
        return
    path = shard_path or remote_shard_path
    with ShardWriter(path) as w:
        for image, basename in frames:
            w.write(f"{basename}.image", encode_image_npy(image))
    if path != remote_shard_path:
        shutil.move(path, remote_shard_path)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", default="imagenet")
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--imagenet-raw-path", required=True)
    parser.add_argument("--tmp-shard-path", default=None)
    parser.add_argument("--split", default="train")
    parser.add_argument("--samples-per-shard", type=int, default=1000)
    args = parser.parse_args(argv)

    if args.dataset != "imagenet":
        raise NotImplementedError(f"{args.dataset} is not supported")

    out_dir = os.path.join(args.output_path, args.dataset, "images")
    os.makedirs(out_dir, exist_ok=True)
    tmp_dir = None
    if args.tmp_shard_path:
        tmp_dir = os.path.join(args.tmp_shard_path, args.dataset)
        os.makedirs(tmp_dir, exist_ok=True)

    if args.split == "train":
        image_paths = sorted(glob.glob(f"{args.imagenet_raw_path}/{args.split}/*/*.JPEG"))
    else:
        image_paths = sorted(glob.glob(f"{args.imagenet_raw_path}/{args.split}/*.JPEG"))

    shard_idx = 0
    buffer: list[tuple[np.ndarray, str]] = []

    def flush() -> None:
        nonlocal shard_idx, buffer
        if not buffer:
            return
        fn = f"{args.dataset}_{args.split}-{shard_idx:06d}-{args.split}.tar"
        local = os.path.join(tmp_dir, fn) if tmp_dir else None
        create_shard(args.dataset, shard_idx, local, os.path.join(out_dir, fn), buffer)
        buffer = []
        shard_idx += 1

    for image_path in image_paths:
        basename = os.path.basename(image_path).split(".")[0]
        buffer.append((_load_resized(image_path), basename))
        if len(buffer) == args.samples_per_shard:
            flush()
    flush()
    print(f"wrote {shard_idx} shards to {out_dir}")


if __name__ == "__main__":
    main()
