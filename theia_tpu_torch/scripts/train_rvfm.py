"""Training CLI of the port (port of theia_tpu/scripts/train_rvfm.py).

Usage:
    python -m theia_tpu_torch.scripts.train_rvfm [CONFIG_NAME] [overrides...] [--device DEVICE]
    python -m theia_tpu_torch.scripts.train_rvfm model/backbone=deit_base \\
        training/target_models=cddsv dataset.dataset_root=/data/theia
    torchrun --nproc_per_node=N -m theia_tpu_torch.scripts.train_rvfm [overrides...]

Trains on the GPU (``--device cuda``, the default); ``--device cpu`` is the
only way onto the CPU. Under torchrun each of the N processes trains on its
own card, ``cuda:LOCAL_RANK``, over NCCL (data parallelism:
``training.batch_size`` rows a card, gradients averaged over the cards,
``training.grad_allreduce_dtype=bfloat16`` halves their all-reduce);
``--device cpu`` under torchrun trains the ranks on the CPU over gloo. The
runtime reads its configs from ``theia_tpu_torch/configs/``.
"""

from __future__ import annotations

import sys

import torch.distributed as dist

from theia_tpu_torch.config import load_config
from theia_tpu_torch.train.loop import train_from_config

USAGE = (
    "usage: python -m theia_tpu_torch.scripts.train_rvfm [CONFIG_NAME] "
    "[group/name=value|dotted.key=value ...] [--device cuda|cpu]\n"
    "  CONFIG_NAME   root config under theia_tpu_torch/configs/ (default: train_rvfm_imagenet)\n"
    "  overrides     hydra-style, e.g. model/backbone=deit_base training.batch_size=32\n"
    "  --device      the device to train on (default: cuda; cuda:LOCAL_RANK under torchrun)"
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
    main_process = True
    try:
        summary = train_from_config(load_config(config_name, overrides=argv), device=device)
    finally:
        if dist.is_initialized():
            main_process = dist.get_rank() == 0
            dist.destroy_process_group()
    if main_process:
        print(summary)
    return summary


if __name__ == "__main__":
    main()
