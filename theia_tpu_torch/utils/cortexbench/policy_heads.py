"""CortexBench policy heads (port of theia_tpu/utils/cortexbench/policy_heads.py:26-129;
reference: src/theia/utils/cortexbench/policy_heads.py:16-240).

A conv neck over the [C*T, 14, 14] stacked features (14 -> 7 -> 3 -> 1 for
``ConvBatchNormMLP``, 14 -> 7 -> 3 for the lighter ``ConvPolicyHead``)
feeding an MLP head, on the port's layers (``models/layers.py``): the
necks' ``LayerNormSpatial`` backward runs K3/K4 on the card
(``csrc/ln_bwd.cu``; C = 256 at 7², 3² and 1², C = 60 at 7² and 3²).
Submodules carry the flax modules' names (``neck_0``, ``head_out``, ...),
so ``models.convert.policy_state_dict`` maps a JAX head's params onto one.
An observation is [B, T*H*W*C (+ proprio)], each of the T frames' features
stored (h, w, c); the neck sees them as NCHW with the channels c-major,
then t (``b (t h w c) -> b (c t) h w``).
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import numpy as np
import torch
from torch import nn

from theia_tpu_torch.models.layers import Conv2dTorch, DenseTorch, LayerNormSpatial, LayerNormTorch


def activation(name: str) -> Callable[[torch.Tensor], torch.Tensor]:
    return torch.relu if name == "relu" else torch.tanh


def split_observation(observation: torch.Tensor, extra_dim: int) -> tuple[torch.Tensor, Any]:
    """(features, extra) of an observation whose last ``extra_dim`` values are extra."""
    if extra_dim > 0:
        return observation[..., :-extra_dim], observation[..., -extra_dim:]
    return observation, None


def stacked_frames(emb: torch.Tensor, t: int, h: int, w: int, c: int) -> torch.Tensor:
    """[B, T*H*W*C] -> [B, C*T, H, W] (channel c*T + t) in channels_last memory."""
    b = emb.shape[0]
    x = emb.reshape(b, t, h, w, c).permute(0, 4, 1, 2, 3).reshape(b, c * t, h, w)
    return x.contiguous(memory_format=torch.channels_last)


class ConvBatchNormMLP(nn.Module):
    """Conv neck (C*T,14,14) -> 256 -> flatten + MLP head, gaussian action
    (reference policy_heads.py:16-176). ``forward`` gives the mean action;
    ``log_std()`` the learnable log std, clamped below at ``min_log_std``."""

    def __init__(
        self,
        embedding_dim: tuple[int, int, int],
        proprio_dim: int,
        history_window: int,
        action_dim: int,
        hidden_sizes: Sequence[int] = (64, 64),
        nonlinearity: str = "relu",
        min_log_std: float = -3.0,
        init_log_std: float = 0.0,
    ) -> None:
        super().__init__()
        self.embedding_dim = tuple(embedding_dim)
        self.proprio_dim = proprio_dim
        self.history_window = history_window
        self.action_dim = action_dim
        self.hidden_sizes = tuple(hidden_sizes)
        self.nonlinearity = nonlinearity
        self.min_log_std = min_log_std
        c = self.embedding_dim[0]
        self.neck_0 = Conv2dTorch(c * history_window, 256, 4, stride=2, padding=1)  # 14 -> 7
        self.neck_1 = LayerNormSpatial((256, 7, 7))
        self.neck_3 = Conv2dTorch(256, 256, 3, stride=2)  # 7 -> 3
        self.neck_4 = LayerNormSpatial((256, 3, 3))
        self.neck_6 = Conv2dTorch(256, 256, 3, stride=1)  # 3 -> 1
        self.neck_7 = LayerNormSpatial((256, 1, 1))
        in_dim = 256 + proprio_dim
        for i, hdim in enumerate(self.hidden_sizes):
            setattr(self, f"head_{i}", DenseTorch(in_dim, hdim))
            in_dim = hdim
        self.head_out = DenseTorch(in_dim, action_dim)
        self.log_std_param = nn.Parameter(torch.full((action_dim,), float(init_log_std)))

    def forward(self, observation: torch.Tensor) -> torch.Tensor:
        """observation: [B, T*H*W*C (+ proprio)] -> mean action [B, A]."""
        act = activation(self.nonlinearity)
        c, h, w = self.embedding_dim
        emb, proprio = split_observation(observation, self.proprio_dim)
        x = stacked_frames(emb, self.history_window, h, w, c)
        x = act(self.neck_1(self.neck_0(x)))
        x = act(self.neck_4(self.neck_3(x)))
        x = act(self.neck_7(self.neck_6(x)))
        x = x.reshape(x.shape[0], -1)
        if proprio is not None:
            x = torch.cat([x, proprio], dim=1)
        for i in range(len(self.hidden_sizes)):
            x = act(getattr(self, f"head_{i}")(x))
        return self.head_out(x)

    def log_std(self) -> torch.Tensor:
        return self.log_std_param.clamp_min(self.min_log_std)


def _mean_action(policy: Callable[[torch.Tensor], torch.Tensor], observation: np.ndarray) -> np.ndarray:
    device = next(policy.parameters()).device if isinstance(policy, nn.Module) else "cpu"
    obs = torch.as_tensor(np.asarray(observation, np.float32)[None], device=device)
    with torch.inference_mode():
        return policy(obs).float().cpu().numpy().ravel()


def get_action(policy: Callable[[torch.Tensor], torch.Tensor], observation: np.ndarray,
               rng: np.random.RandomState, log_std: float = 0.0) -> tuple[np.ndarray, dict]:
    """Stochastic rollout action (reference :148-162): the mean plus
    exp(log_std) times ``rng``'s normal noise."""
    mean = _mean_action(policy, observation)
    noise = np.exp(log_std) * rng.randn(mean.shape[0])
    return mean + noise, {"mean": mean, "log_std": log_std, "evaluation": mean}


def get_action_deterministic(policy: Callable[[torch.Tensor], torch.Tensor],
                             observation: np.ndarray) -> tuple[np.ndarray, dict]:
    """Deterministic rollout action (reference :164-176)."""
    action = _mean_action(policy, observation)
    return action, {"mean": action, "log_std": 0, "evaluation": action}


class ConvPolicyHead(nn.Module):
    """The smaller neck and head (reference policy_heads.py:179-240): conv
    14 -> 7 -> 3 with 60 channels, MLP 60*9 (+ proprio) -> 256 -> A. The
    neck's map is flattened (h, w, c), as the NHWC JAX head flattens it."""

    def __init__(self, embedding_dim: tuple[int, int, int], proprio_dim: int, history_window: int, action_dim: int,
                 nonlinearity: str = "relu") -> None:
        super().__init__()
        self.embedding_dim = tuple(embedding_dim)
        self.proprio_dim = proprio_dim
        self.history_window = history_window
        self.action_dim = action_dim
        self.nonlinearity = nonlinearity
        c = self.embedding_dim[0]
        self.neck_0 = Conv2dTorch(c * history_window, 60, 4, stride=2, padding=1)
        self.neck_1 = LayerNormSpatial((60, 7, 7))
        self.neck_3 = Conv2dTorch(60, 60, 3, stride=2)
        self.neck_4 = LayerNormSpatial((60, 3, 3))
        self.head_0 = DenseTorch(60 * 9 + proprio_dim, 256)
        self.head_1 = LayerNormTorch(256)
        self.head_3 = DenseTorch(256, action_dim)

    def forward(self, observation: torch.Tensor) -> torch.Tensor:
        act = activation(self.nonlinearity)
        c, h, w = self.embedding_dim
        emb, proprio = split_observation(observation, self.proprio_dim)
        x = stacked_frames(emb, self.history_window, h, w, c)
        x = act(self.neck_1(self.neck_0(x)))
        x = act(self.neck_4(self.neck_3(x)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        if proprio is not None:
            x = torch.cat([x, proprio], dim=1)
        return self.head_3(act(self.head_1(self.head_0(x))))
