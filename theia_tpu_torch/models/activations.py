"""Activation registry (port of theia_tpu/models/activations.py:10-22)."""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F


def get_activation_fn(activation: str) -> Callable[[torch.Tensor], torch.Tensor]:
    """The named activation as a torch function; ``gelu`` is the exact (erf) one."""
    table = {
        "relu": F.relu,
        "gelu": lambda x: F.gelu(x, approximate="none"),
        "tanh": torch.tanh,
        "leaky_relu": F.leaky_relu,
    }
    if activation not in table:
        raise ValueError(f"{activation} is not defined in theia_tpu_torch.models.activations")
    return table[activation]
