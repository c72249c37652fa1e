"""Optimizer and LR schedules of the reference recipe (port of theia_tpu/train/optim.py:26-189).

- AdamW (betas 0.9/0.999) with no weight decay for parameters of ndim <= 1
  and for biases, decay otherwise (the (C,H,W) LayerNorm weights decay);
- LR scaling lr = base_lr * (batch*world) / (base_batch*base_world);
- schedules: linear warmup (start factor 1e-2), then constant or cosine
  annealing with warm restarts (T_mult=1);
- an optional translator LR factor, applied as an update scale.

Plain functions over dicts of tensors keyed by parameter name, not
``torch.optim.AdamW``: that has neither the JAX package's masking (a masked
parameter keeps its value, its moments and its own step count) nor a step
count per parameter under a mask. Unlike the JAX package, which returns new
parameters and state, ``MaskedAdamW.update`` updates both in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional

import torch

from theia_tpu_torch.parallel.tp import model_sum

Schedule = Callable[[Any], torch.Tensor]


def scaled_lr(base_lr: float, batch_size: int, world_size: int,
              base_batch_size: int = 64, base_world_size: int = 8) -> float:
    return base_lr * (batch_size * world_size) / (base_batch_size * base_world_size)


def _step_f32(step: Any) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant_with_warmup(lr: float, warm_up_steps: int, warm_up_lr_start_factor: float = 1e-2) -> Schedule:
    """Linear warmup to lr, then constant; the step may be an int or a device tensor."""

    def schedule(step: Any) -> torch.Tensor:
        step = _step_f32(step)
        frac = torch.clamp(step / max(warm_up_steps, 1), max=1.0)
        factor = warm_up_lr_start_factor + (1.0 - warm_up_lr_start_factor) * frac
        return lr * torch.where(step < warm_up_steps, factor, 1.0)

    return schedule


def cosine_restarts_with_warmup(
    lr: float,
    warm_up_steps: int,
    cos_lrs_T_0: int,
    warm_up_lr_start_factor: float = 1e-2,
    eta_min: float = 0.0,
) -> Schedule:
    """Linear warmup, then CosineAnnealingWarmRestarts(T_0, T_mult=1)."""

    def schedule(step: Any) -> torch.Tensor:
        step = _step_f32(step)
        frac = torch.clamp(step / max(warm_up_steps, 1), max=1.0)
        warm = lr * (warm_up_lr_start_factor + (1.0 - warm_up_lr_start_factor) * frac)
        t_cur = torch.remainder(step - warm_up_steps, cos_lrs_T_0)
        cos = eta_min + (lr - eta_min) * (1.0 + torch.cos(math.pi * t_cur / cos_lrs_T_0)) / 2.0
        return torch.where(step < warm_up_steps, warm, cos)

    return schedule


def no_weight_decay_mask(params: Mapping[str, torch.Tensor]) -> dict[str, bool]:
    """True where weight decay applies: ndim > 1 and a name not ending in "bias"."""
    return {name: p.ndim > 1 and not name.endswith("bias") for name, p in params.items()}


@dataclasses.dataclass
class MaskedAdamWState:
    """AdamW state with a step count per parameter.

    ``sched_count`` drives the LR schedule and advances every step; ``count``
    advances only for the parameters a step updates (torch.optim.AdamW's
    per-parameter ``state["step"]``, which skips parameters without a grad).
    """

    sched_count: torch.Tensor
    count: dict[str, torch.Tensor]
    mu: dict[str, torch.Tensor]
    nu: dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MaskedAdamW:
    """AdamW with the reference's decay mask and masking that freezes a parameter completely.

    ``update(grads, state, params, mask=None)``: ``mask`` maps some names to
    {0, 1} scalars; a 0 leaves that parameter, its moments and its count
    untouched, as torch leaves a parameter without a grad. Names not in
    ``mask`` update. ``moment_dtype`` stores the moments narrower (bf16);
    the update math runs in the grad's dtype and only the carried state
    rounds. The translator LR factor scales the update of parameters under
    ``translator.``: exact for AdamW, whose Adam term and decoupled decay
    both scale with lr.
    """

    learning_rate: float | Schedule
    weight_decay: float = 0.01
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    translator_lr_factor: float = 1.0
    moment_dtype: Optional[torch.dtype] = None

    def init(self, params: Mapping[str, torch.Tensor]) -> MaskedAdamWState:
        device = next(iter(params.values())).device

        def zeros(p: torch.Tensor) -> torch.Tensor:
            return torch.zeros(p.shape, dtype=self.moment_dtype or p.dtype, device=p.device)

        return MaskedAdamWState(
            sched_count=torch.zeros((), dtype=torch.int32, device=device),
            count={n: torch.zeros((), dtype=torch.int32, device=p.device) for n, p in params.items()},
            mu={n: zeros(p) for n, p in params.items()},
            nu={n: zeros(p) for n, p in params.items()},
        )

    @torch.no_grad()
    def update(
        self,
        grads: Mapping[str, torch.Tensor],
        state: MaskedAdamWState,
        params: Mapping[str, torch.Tensor],
        *,
        mask: Optional[Mapping[str, Any]] = None,
    ) -> None:
        """One step over ``grads``; updates ``params`` and ``state`` in place."""
        b1, b2 = self.betas
        lr = self.learning_rate(state.sched_count) if callable(self.learning_rate) else self.learning_rate
        decay = no_weight_decay_mask(params)
        for name, g in grads.items():
            p, mu, nu = params[name], state.mu[name], state.nu[name]
            mu_g, nu_g = mu.to(g.dtype), nu.to(g.dtype)
            m = None if mask is None or name not in mask else torch.as_tensor(mask[name], dtype=g.dtype, device=g.device)
            if m is None:
                count = state.count[name] + 1
                mu1 = b1 * mu_g + (1.0 - b1) * g
                nu1 = b2 * nu_g + (1.0 - b2) * g * g
            else:
                count = state.count[name] + m.to(torch.int32)
                mu1 = m * (b1 * mu_g + (1.0 - b1) * g) + (1.0 - m) * mu_g
                nu1 = m * (b2 * nu_g + (1.0 - b2) * g * g) + (1.0 - m) * nu_g
            cf = count.to(g.dtype)
            # a parameter never updated (count 0) would divide by 0
            bc1 = torch.where(count > 0, 1.0 - b1**cf, 1.0)
            bc2 = torch.where(count > 0, 1.0 - b2**cf, 1.0)
            step = (mu1 / bc1) / (torch.sqrt(nu1 / bc2) + self.eps)
            if decay[name]:
                step = step + self.weight_decay * p
            u = -lr * step if m is None else -lr * m * step
            if self.translator_lr_factor != 1.0 and name.startswith("translator."):
                u = u * self.translator_lr_factor
            p.add_(u)
            mu.copy_(mu1)
            nu.copy_(nu1)
            state.count[name] = count
        state.sched_count += 1


def make_optimizer(
    learning_rate: float | Schedule,
    weight_decay: float = 0.01,
    betas: tuple[float, float] = (0.9, 0.999),
    eps: float = 1e-8,
    translator_lr_factor: float = 1.0,
    moment_dtype: Optional[torch.dtype] = None,
) -> MaskedAdamW:
    """The JAX ``make_optimizer``: masked AdamW (see ``MaskedAdamW``)."""
    return MaskedAdamW(learning_rate, weight_decay, tuple(betas), eps, translator_lr_factor, moment_dtype)


def clip_grad_norm(grads: Mapping[str, torch.Tensor], max_norm: float | torch.Tensor, layout: Any = None
                   ) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """torch ``clip_grad_norm_`` semantics, scale = min(1, max_norm / (norm + 1e-6));
    returns the scaled grads and the global norm, both on the device.
    ``layout``: a cut model's ``parallel.tp.TPLayout``; the squares of its
    split gradients are summed over the model group, the replicated
    gradients counted once."""
    squares = [g.float().square().sum() for n, g in grads.items() if layout is None or not layout.is_split(n)]
    norm_sq = torch.stack(squares).sum()
    if layout is not None:
        split = [g.float().square().sum() for n, g in grads.items() if layout.is_split(n)]
        norm_sq = norm_sq + model_sum(torch.stack(split).sum(), layout.grid)
    norm = norm_sq.sqrt()
    scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    return {n: g * scale.to(g.dtype) for n, g in grads.items()}, norm
