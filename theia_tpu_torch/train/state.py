"""Train state: step, params and optimizer state (port of theia_tpu/train/state.py)."""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch


@dataclasses.dataclass
class TrainState:
    """``step`` is an int32 scalar on the device; ``params`` maps names to
    the model's own parameters (so updating them in place trains the
    model); ``opt_state`` is the optimizer's state."""

    step: torch.Tensor
    params: dict[str, torch.Tensor]
    opt_state: Any

    @classmethod
    def create(cls, params: Mapping[str, torch.Tensor], tx: Any) -> "TrainState":
        params = dict(params)
        device = next(iter(params.values())).device
        return cls(step=torch.zeros((), dtype=torch.int32, device=device), params=params, opt_state=tx.init(params))
