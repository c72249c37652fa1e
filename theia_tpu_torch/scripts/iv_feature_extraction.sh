#!/usr/bin/env bash
# Batch script: extract every teacher's features for the image/video datasets
# (reference: src/theia/scripts/preprocessing/iv_feature_extraction.sh).
# Each teacher runs on the card (feature_extraction's --device, cuda by
# default); under several processes the shards are partitioned by process.
set -euo pipefail

DATASET_ROOT="${DATASET_ROOT:-/data/theia}"
OUTPUT_PATH="${OUTPUT_PATH:-$DATASET_ROOT}"
DATASETS=(${DATASETS:-imagenet})
MODELS=(
  "google/vit-huge-patch14-224-in21k"
  "facebook/dinov2-large"
  "openai/clip-vit-large-patch14"
  "facebook/sam-vit-huge"
  "LiheYoung/depth-anything-large-hf"
)

for dataset in "${DATASETS[@]}"; do
  for split in train val; do
    for model in "${MODELS[@]}"; do
      python -m theia_tpu_torch.scripts.feature_extraction \
        --dataset "$dataset" --split "$split" --model "$model" \
        --dataset-root "$DATASET_ROOT" --output-path "$OUTPUT_PATH"
    done
  done
done

python -m theia_tpu_torch.scripts.calc_feature_mean \
  --dataset-path "$OUTPUT_PATH/imagenet" --output-path "$OUTPUT_PATH"
