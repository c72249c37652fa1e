"""Training CLI of the port (port of theia_tpu/scripts/train_rvfm.py).

Usage:
    python -m theia_tpu_torch.scripts.train_rvfm [CONFIG_NAME] [overrides...] [--device DEVICE]
    python -m theia_tpu_torch.scripts.train_rvfm model/backbone=deit_base \\
        training/target_models=cddsv dataset.dataset_root=/data/theia

Trains on the GPU (``--device cuda``, the default); ``--device cpu`` is the
only way onto the CPU. One process on one device: the runtime reads its
configs from ``theia_tpu_torch/configs/``.
"""

from __future__ import annotations

import sys

from theia_tpu_torch.config import load_config
from theia_tpu_torch.train.loop import train_from_config

USAGE = (
    "usage: python -m theia_tpu_torch.scripts.train_rvfm [CONFIG_NAME] "
    "[group/name=value|dotted.key=value ...] [--device cuda|cpu]\n"
    "  CONFIG_NAME   root config under theia_tpu_torch/configs/ (default: train_rvfm_imagenet)\n"
    "  overrides     hydra-style, e.g. model/backbone=deit_base training.batch_size=32\n"
    "  --device      the device to train on (default: cuda)"
)


def main(argv: list[str] | None = None) -> dict | None:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("-h", "--help"):
        print(USAGE)
        return None
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        device = argv[i + 1]
        del argv[i : i + 2]
    config_name = "train_rvfm_imagenet"
    if argv and "=" not in argv[0]:
        config_name = argv.pop(0)
    summary = train_from_config(load_config(config_name, overrides=argv), device=device)
    print(summary)
    return summary


if __name__ == "__main__":
    main()
