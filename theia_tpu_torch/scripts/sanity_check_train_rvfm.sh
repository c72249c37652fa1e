#!/usr/bin/env bash
# Smoke train (reference: src/theia/scripts/train/sanity_check_train_rvfm.sh:4-5
# runs 1-GPU training at data_portion=0.001). Point DATASET_ROOT at a real or
# synthetic dataset (theia_tpu_torch.data.synthetic can generate one).
set -euo pipefail
DATASET_ROOT="${1:-/tmp/theia_sanity}"

if [ ! -d "$DATASET_ROOT/imagenet" ]; then
  python - "$DATASET_ROOT" <<'EOF'
import sys
from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
generate_synthetic_dataset(
    sys.argv[1],
    feature_models={
        "google/vit-huge-patch14-224-in21k": (1280, 16, 16),
        "facebook/dinov2-large": (1024, 16, 16),
        "openai/clip-vit-large-patch14": (1024, 16, 16),
    },
    n_train=64, n_val=16, samples_per_shard=16,
)
print("synthetic sanity dataset at", sys.argv[1])
EOF
fi

python -m theia_tpu_torch.scripts.train_rvfm \
  dataset.dataset_root="$DATASET_ROOT" \
  dataset.dataset_ratio=1.0 \
  dataset.shuffle_buffer_size=16 \
  training.epochs=1 \
  training.batch_size=4 \
  logging.model_path="$DATASET_ROOT/ckpt" \
  logging.log_path="$DATASET_ROOT/logs" \
  logging.log_interval=1
