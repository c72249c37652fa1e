"""Distillation training of the PyTorch port: losses' step, masked AdamW, schedules.

The public names are the JAX package's (``theia_tpu/train/__init__.py``).
"""

from theia_tpu_torch.train.optim import (
    constant_with_warmup,
    cosine_restarts_with_warmup,
    make_optimizer,
    no_weight_decay_mask,
    scaled_lr,
)
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_eval_step, make_train_step

__all__ = [
    "cosine_restarts_with_warmup",
    "constant_with_warmup",
    "make_optimizer",
    "no_weight_decay_mask",
    "scaled_lr",
    "TrainState",
    "make_train_step",
    "make_eval_step",
]
