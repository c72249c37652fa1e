"""Offline teacher feature extraction to webdataset shards (port of
theia_tpu/scripts/feature_extraction.py; reference:
src/theia/scripts/preprocessing/feature_extraction.py).

Streams image shards, runs the teacher on the GPU in batches, and writes
per-model safetensors shards with resume checking (a shard that passes
``check_existing_shard`` is skipped, :198-209). One process drives one
card; a run over many cards or hosts partitions the shards by
(``--rank``, ``--world-size``), else by the ``RANK`` and ``WORLD_SIZE``
environment variables, else runs them all: launch one process per card.

Weights: an HF checkpoint of the teacher in the local Hugging Face cache
(``$HF_HUB_CACHE``, else ``$HF_HOME/hub``, else
``~/.cache/huggingface/hub``), read from its ``model.safetensors`` (or the
shards its index names) without ``transformers``; else a seeded random
init, with a warning, for pipeline tests.

Usage:
    python -m theia_tpu_torch.scripts.feature_extraction \\
        --dataset imagenet --split train --model facebook/dinov2-large \\
        --dataset-root /data/theia --output-path /data/theia \\
        [--batch-size 32] [--dry-run] [--rank R --world-size N] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import mmap
import os
from os.path import join
from typing import Optional

import torch


def iter_image_shards(dataset_dir: str, split: str) -> list[str]:
    return sorted(glob.glob(join(dataset_dir, "images", f"*-{split}.tar")))


def iter_oxe_episodes(dataset_name: str, split: str = "train"):
    """Stream OXE episodes from the public GCS tfds buckets (reference
    feature_extraction.py:51-56,73-97). Requires tensorflow_datasets
    (optional, like the reference's OXE path); yields
    (episode_index, vo_key, uint8 frames [T,H,W,3])."""
    try:
        import tensorflow_datasets as tfds
    except ImportError as e:  # pragma: no cover - optional dependency
        raise ImportError(
            "OXE extraction streams tfds episodes from GCS and needs "
            "tensorflow_datasets installed"
        ) from e

    import numpy as np

    from theia_tpu_torch.data.oxe import get_vo_keys, oxe_dsname2path

    builder = tfds.builder_from_directory(builder_dir=oxe_dsname2path(dataset_name))
    ds = builder.as_dataset(split=split)
    vo_keys = get_vo_keys(dataset_name)
    for ep_idx, episode in enumerate(ds):
        for vo_key in vo_keys:
            frames = np.stack(
                [step["observation"][vo_key].numpy() for step in episode["steps"]]
            )
            yield ep_idx, vo_key, frames


def hf_cache_files(model_name: str) -> Optional[list[str]]:
    """The safetensors files of ``model_name``'s snapshot in the local HF hub
    cache (its ``refs/main`` snapshot, else the newest), or None."""
    cache_dir = os.environ.get("HF_HUB_CACHE") or os.environ.get("HUGGINGFACE_HUB_CACHE") or join(
        os.environ.get("HF_HOME") or join(os.path.expanduser("~"), ".cache", "huggingface"), "hub")
    repo = join(cache_dir, "models--" + model_name.replace("/", "--"))
    snapshots = []
    ref = join(repo, "refs", "main")
    if os.path.exists(ref):
        with open(ref) as f:
            snapshots.append(join(repo, "snapshots", f.read().strip()))
    snapshots += sorted(glob.glob(join(repo, "snapshots", "*")), key=os.path.getmtime, reverse=True)
    for snap in snapshots:
        single = join(snap, "model.safetensors")
        if os.path.exists(single):
            return [single]
        index = join(snap, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                shards = sorted(set(json.load(f)["weight_map"].values()))
            return [join(snap, s) for s in shards]
    return None


def read_safetensors_file(path: str) -> dict[str, torch.Tensor]:
    """A safetensors file's tensors, read through a copy-on-write mmap."""
    from theia_tpu_torch.data.webdataset import load_safetensors

    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    return load_safetensors(mm)


def load_cached_state_dict(model_name: str) -> Optional[dict[str, torch.Tensor]]:
    """``model_name``'s HF state dict from the local cache, or None."""
    files = hf_cache_files(model_name)
    if not files:
        return None
    sd: dict[str, torch.Tensor] = {}
    for path in files:
        sd.update(read_safetensors_file(path))
    return sd


def extract_shard(
    shard_path: str,
    out_path: str,
    model_name: str,
    module,
    feature_fn,
    batch_size: int,
    dry_run: bool = False,
) -> int:
    """Extract one image shard -> one feature shard on the module's device.
    Returns sample count."""
    from theia_tpu_torch.data.webdataset import ShardWriter, decode_image_npy, iter_samples, save_safetensors
    from theia_tpu_torch.foundation.extraction import extract_batch

    legit = model_name.replace("/", "_")
    samples = [(k, decode_image_npy(f["image"])) for k, f in iter_samples(shard_path)]
    if dry_run:
        return len(samples)
    writer = ShardWriter(out_path)
    count = 0
    for n, i in enumerate(range(0, len(samples), batch_size)):
        batch = samples[i : i + batch_size]
        per_sample = extract_batch(model_name, module, torch.stack([b[1] for b in batch]), feature_fn, unit=n)
        for (key, _), features in zip(batch, per_sample):
            writer.write(f"{key}.{legit}.safetensors", save_safetensors(features))
            count += 1
    writer.close()
    return count


def build_teacher(model_name: str, device: str | torch.device):
    """(module, feature_fn) on ``device``: the cached HF weights of
    ``model_name``, else a random init seeded with 0, with the JAX script's
    warning."""
    from theia_tpu_torch.foundation.extraction import get_model

    sd = load_cached_state_dict(model_name)
    if sd is not None:
        try:
            return get_model(model_name, state_dict=sd, device=device)
        except Exception as e:  # a checkpoint of another layout: as the JAX script, fall back
            print(f"cached weights for {model_name} did not load ({type(e).__name__}: {e})")
    print(f"WARNING: no pretrained weights for {model_name}; using random init")
    return get_model(model_name, device=device, generator=torch.Generator(device).manual_seed(0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="train")
    parser.add_argument("--model", required=True)
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--output-path", default=None)
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--dry-run", action="store_true")
    parser.add_argument("--rank", type=int, default=None, help="process index override")
    parser.add_argument("--world-size", type=int, default=None)
    parser.add_argument("--device", default="cuda", help="the device the teacher runs on (default: cuda)")
    args = parser.parse_args(argv)

    from theia_tpu_torch.data.webdataset import check_existing_shard

    rank = args.rank if args.rank is not None else int(os.environ.get("RANK", 0))
    world = args.world_size if args.world_size is not None else int(os.environ.get("WORLD_SIZE", 1))

    out_root = args.output_path or args.dataset_root
    dataset_dir = join(args.dataset_root, args.dataset)
    shards = iter_image_shards(dataset_dir, args.split)
    if not shards:
        raise FileNotFoundError(f"no image shards under {dataset_dir}/images for split {args.split}")
    my_shards = shards[rank::world]

    module = feature_fn = None
    if not args.dry_run:
        module, feature_fn = build_teacher(args.model, args.device)

    legit = args.model.replace("/", "_")
    out_dir = join(out_root, args.dataset, legit)
    os.makedirs(out_dir, exist_ok=True)
    total = 0
    for shard_path in my_shards:
        out_name = os.path.basename(shard_path)
        out_path = join(out_dir, out_name)
        ok, _ = check_existing_shard(out_path, [legit])
        if ok:
            print(f"{args.dataset} {legit} {out_name} check pass, skipping")
            continue
        n = extract_shard(
            shard_path, out_path, args.model, module, feature_fn, args.batch_size, dry_run=args.dry_run,
        )
        total += n
        print(f"{args.dataset} {legit} {out_name} done ({n} samples)")
    print(f"extracted {total} samples across {len(my_shards)} shards")
    return total


if __name__ == "__main__":
    main()
