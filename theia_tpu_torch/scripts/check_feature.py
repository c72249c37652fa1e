"""Data-integrity check: re-extract random samples on the port's teacher and
compare with stored features bit-exactly (port of
theia_tpu/scripts/check_feature.py; reference:
src/theia/scripts/preprocessing/check_feature.py:88-205). Doubles as the
teacher-port numerics test when run against reference-produced shards.

Usage:
    python -m theia_tpu_torch.scripts.check_feature --dataset-root /data/theia \\
        --dataset imagenet --split val [--models facebook/dinov2-large ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

from theia_tpu_torch.data.webdataset import decode_image_npy, iter_samples, load_safetensors
from theia_tpu_torch.utils.seed import seed_everything


def check_shard(
    dataset_dir: str,
    model_name: str,
    shard_idx: int,
    sample_indices: np.ndarray,
    split: str,
    module,
    feature_fn,
    check_feature_name: bool = True,
) -> bool:
    """Regenerate ``sample_indices`` of shard ``shard_idx`` as one batch on
    the module's device; True if every embedding is bit-exact (and the
    sample names agree). Prints sum|d| and max|d|."""
    from theia_tpu_torch.foundation.extraction import get_feature_outputs

    legit = model_name.replace("/", "_")
    image_shards = sorted(glob.glob(os.path.join(dataset_dir, "images", f"*-{split}.tar")))
    feat_shards = sorted(glob.glob(os.path.join(dataset_dir, legit, f"*-{split}.tar")))
    images = list(iter_samples(image_shards[shard_idx]))
    feats = list(iter_samples(feat_shards[shard_idx]))

    sel_imgs = [(images[i][0], decode_image_npy(images[i][1]["image"])) for i in sample_indices]
    sel_feats = []
    for i in sample_indices:
        key, fields = feats[i]
        sel_feats.append((key, load_safetensors(next(iter(fields.values())))["embedding"]))

    device = next(module.parameters()).device
    batch = torch.stack([img for _, img in sel_imgs]).to(device)
    regen = get_feature_outputs(model_name, module, batch, feature_fn)[legit]["embedding"].float()
    stored = torch.stack([f.float() for _, f in sel_feats])
    diff = (regen - stored).abs()
    bit_exact = bool((diff == 0).all())
    print(f"{model_name} shard {shard_idx}: sum|d|={float(diff.sum()):.4g} max|d|={float(diff.max()):.4g}")
    names_ok = all(ik == fk for (ik, _), (fk, _) in zip(sel_imgs, sel_feats))
    return bit_exact and (names_ok or not check_feature_name)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-root", required=True)
    parser.add_argument("--dataset", required=True)
    parser.add_argument("--split", default="val")
    parser.add_argument("--samples-per-shard", type=int, default=1000)
    parser.add_argument("--models", nargs="*", default=None)
    parser.add_argument("--num-shards", type=int, default=5)
    parser.add_argument("--samples-per-check", type=int, default=8)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda", help="the device the teachers run on (default: cuda)")
    args = parser.parse_args(argv)

    from theia_tpu_torch.foundation.common import MODELS
    from theia_tpu_torch.foundation.extraction import get_model
    from theia_tpu_torch.scripts.feature_extraction import load_cached_state_dict

    seed_everything(args.seed)
    dataset_dir = os.path.join(args.dataset_root, args.dataset)
    with open(os.path.join(dataset_dir, "splits.json")) as f:
        dataset_len = json.load(f)[args.split]
    n_shards = max(dataset_len // args.samples_per_shard, 1)

    model_names = args.models or [m for m in MODELS if "llava" not in m]
    results: dict[str, list[bool]] = {m: [] for m in model_names}
    for model_name in model_names:
        sd = load_cached_state_dict(model_name)
        if sd is None:
            raise RuntimeError(f"no weights available for {model_name}")
        module, feature_fn = get_model(model_name, state_dict=sd, device=args.device)
        shard_indices = np.random.permutation(n_shards)[: args.num_shards]
        for shard_idx in shard_indices:
            sample_indices = np.random.permutation(args.samples_per_shard)[: args.samples_per_check]
            ok = check_shard(
                dataset_dir, model_name, int(shard_idx), sample_indices, args.split, module, feature_fn,
            )
            results[model_name].append(ok)
    failed = [m for m, oks in results.items() if not all(oks)]
    for m in failed:
        print(f"{args.dataset} {args.split} {m} check failed!!!")
    if not failed:
        print("all checks passed")


if __name__ == "__main__":
    main()
