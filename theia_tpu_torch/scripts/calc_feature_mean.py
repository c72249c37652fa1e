"""Channel-wise mean/std of extracted features (port of
theia_tpu/scripts/calc_feature_mean.py; reference:
src/theia/scripts/preprocessing/calc_feature_mean.py:41-91).

Two streaming passes per model directory, in float64 as the JAX script:
running mean, then std = sqrt(sum((x - mean)^2) / (n - 1)) — note the
reference names the std file "var" and the training normalizer divides by
it (data_utils.py:342-355).

Usage:
    python -m theia_tpu_torch.scripts.calc_feature_mean \\
        --dataset-path /data/theia/imagenet --output-path /data/theia
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from theia_tpu_torch.data.webdataset import iter_samples, load_safetensors


def _iter_embeddings(model_dir: str):
    for shard in sorted(glob.glob(os.path.join(model_dir, "*.tar"))):
        for _, fields in iter_samples(shard):
            sft = load_safetensors(next(iter(fields.values())))
            emb = sft["embedding"].float().numpy()  # [C, H, W]
            yield emb.reshape(emb.shape[0], -1).T  # [(H W), C]


def compute_feature_stats(model_dir: str) -> tuple[np.ndarray, np.ndarray]:
    mean = None
    n = 0
    for emb in _iter_embeddings(model_dir):
        if mean is None:
            mean = np.zeros(emb.shape[-1], np.float64)
        new_n = emb.shape[0]
        mean = (mean * n + emb.mean(0) * new_n) / (n + new_n)
        n += new_n
    if mean is None:
        raise FileNotFoundError(f"no shards under {model_dir}")
    var_sum = np.zeros_like(mean)
    for emb in _iter_embeddings(model_dir):
        var_sum += ((emb - mean) ** 2).sum(0)
    std = np.sqrt(var_sum / (n - 1))
    return mean.astype(np.float32), std.astype(np.float32)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--dataset-path", required=True)
    parser.add_argument("--output-path", required=True)
    args = parser.parse_args(argv)

    models = [
        m for m in os.listdir(args.dataset_path)
        if os.path.isdir(os.path.join(args.dataset_path, m))
        and m not in ("images", "image", "images_val")
    ]
    os.makedirs(args.output_path, exist_ok=True)
    for model in models:
        mean_path = os.path.join(args.output_path, f"imagenet_mean_{model}.npy")
        if os.path.exists(mean_path):
            continue
        mean, std = compute_feature_stats(os.path.join(args.dataset_path, model))
        np.save(mean_path, mean)
        np.save(os.path.join(args.output_path, f"imagenet_var_{model}.npy"), std)
        print(f"{model}: mean/std over C={mean.shape[0]} saved")


if __name__ == "__main__":
    main()
