"""TriFinger deterministic policy (port of theia_tpu/utils/cortexbench/trifinger/policy.py:19-101;
reference: src/theia/utils/cortexbench/trifinger/policy.py:15-123)."""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from theia_tpu_torch.models.layers import Conv2dTorch, DenseTorch
from theia_tpu_torch.utils.cortexbench.policy_heads import activation, split_observation


class ConvBatchNormMLPDeterministicPolicy(nn.Module):
    """Conv neck (14 -> 7 -> 3 -> 1) + a 2-hidden-layer MLP, deterministic
    action. The state is [B, 14*14*C (+ extra)], the features stored
    (h, w, c) (reference :31)."""

    def __init__(self, in_dim: tuple[int, ...], extra_dim: int, out_dim: int, max_a: Optional[float] = None,
                 hidden_size: int = 256, nonlinearity: str = "relu") -> None:
        super().__init__()
        self.in_dim = tuple(in_dim)
        self.extra_dim = extra_dim
        self.out_dim = out_dim
        self.max_a = max_a
        self.hidden_size = hidden_size
        self.nonlinearity = nonlinearity
        c = self.in_dim[0]
        self.neck_1 = Conv2dTorch(c, 256, 4, stride=2, padding=1)  # 7
        self.neck_3 = Conv2dTorch(256, 256, 3, stride=2)  # 3
        self.neck_5 = Conv2dTorch(256, 256, 3, stride=1)  # 1
        self.policy_0 = DenseTorch(256 + extra_dim, hidden_size)
        self.policy_2 = DenseTorch(hidden_size, hidden_size)
        self.policy_4 = DenseTorch(hidden_size, out_dim)

    def forward(self, state: torch.Tensor) -> torch.Tensor:
        act = activation(self.nonlinearity)
        visual, extra = split_observation(state, self.extra_dim)
        b = visual.shape[0]
        x = visual.reshape(b, 14, 14, self.in_dim[0]).permute(0, 3, 1, 2)
        x = act(self.neck_1(x.contiguous(memory_format=torch.channels_last)))
        x = act(self.neck_3(x))
        x = act(self.neck_5(x)).reshape(b, -1)
        if extra is not None:
            x = torch.cat([x, extra], dim=1)
        x = act(self.policy_0(x))
        x = act(self.policy_2(x))
        return self.policy_4(x)

    def clip_action(self, a: torch.Tensor) -> torch.Tensor:
        if self.max_a is None:
            return a
        return a.clamp(-self.max_a, self.max_a)

    def scale_to_range(self, a: torch.Tensor) -> torch.Tensor:
        return a


def construct_policy(
    type: str,
    task_state_type: str,
    train_ft_state_shape: int,
    pretrained_dim: tuple[int, ...],
    task_goal_type: str,
    out_dim: int,
    max_a: Any = None,
    hidden_size: int = 256,
    nonlinearity: str = "relu",
    **kwargs: Any,
) -> ConvBatchNormMLPDeterministicPolicy:
    """The reference's factory (:80-123): the goal and state conditioning
    set the input channels and the extra dims."""
    in_dim = pretrained_dim
    extra_dim = 0
    if task_state_type == "obj":
        extra_dim += 0
    elif task_state_type in ("ftpos_obj", "ftpos"):
        extra_dim += train_ft_state_shape
    else:
        raise NameError("Invalid state_type")

    if task_goal_type == "goal_none":
        in_dim = pretrained_dim
    elif task_goal_type == "goal_cond":
        in_dim = (pretrained_dim[0] * 2, *pretrained_dim[1:])
    elif task_goal_type == "goal_o_pos":
        extra_dim += 3
    else:
        raise NameError("Invalid goal_type")

    if type == "ConvBatchNormMLP":
        return ConvBatchNormMLPDeterministicPolicy(
            in_dim=in_dim, extra_dim=extra_dim, out_dim=out_dim,
            max_a=max_a, hidden_size=hidden_size, nonlinearity=nonlinearity,
        )
    raise NotImplementedError(f"Policy network {type} is not supported.")
