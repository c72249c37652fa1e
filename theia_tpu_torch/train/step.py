"""The distillation train and eval steps (port of theia_tpu/train/step.py:49-71,74-268,348-377).

uint8 images and raw teacher features go in; the step runs the model, the
loss, the gradients, the optional grad clip and the masked AdamW update on
the device, and returns metrics as device tensors (nothing is read back to
the host inside a step). Left out with the JAX package's TPU and mesh
toggles: ``mesh=``, ``grad_allreduce_dtype``, ``donate``,
``compiler_options`` and ``DEFAULT_COMPILER_OPTIONS``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
from torch import nn

from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
from theia_tpu_torch.models.translators import head_key
from theia_tpu_torch.train.optim import clip_grad_norm
from theia_tpu_torch.train.state import TrainState

_TERMS = ("mse_loss", "cos_loss", "l1_loss")
_PER_MODEL = ("mse_losses_per_model", "cos_losses_per_model", "l1_losses_per_model")


def prepare_targets(
    targets: Mapping[str, torch.Tensor],
    target_stats: Optional[Mapping[str, tuple]] = None,
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Raw [B, C, H, W] teacher features -> [B, H*W, C] in ``dtype``, then
    (x - mean) / std where ``target_stats`` has the teacher; on the device.

    The transpose is made in the same copy as the cast, so the result is
    contiguous: the fused loss reads it as [B, D] rows without a copy of its
    own (``ops.fused_loss.flat_rows``)."""
    out = {}
    for t, arr in targets.items():
        if arr.ndim == 4:
            b, c = arr.shape[:2]
            arr = arr.reshape(b, c, -1).transpose(1, 2)
        arr = arr.to(dtype, memory_format=torch.contiguous_format)
        if target_stats is not None and t in target_stats:
            mean, std = target_stats[t]
            if mean is not None:
                arr = (arr - torch.as_tensor(mean, dtype=dtype, device=arr.device)) / torch.as_tensor(
                    std, dtype=dtype, device=arr.device
                )
        out[t] = arr
    return out


def _metrics(main: torch.Tensor, losses: Mapping[str, Any]) -> dict[str, Any]:
    metrics: dict[str, Any] = {"loss": main.detach(), **{k: losses[k].detach() for k in _TERMS}}
    for k in _PER_MODEL:
        metrics[k] = {t: v.detach() for t, v in losses[k].items()}
    return metrics


def make_train_step(
    model: nn.Module,
    tx: Any,
    *,
    main_loss: str = "cos_l1",
    target_loss_weights: Optional[Mapping[str, float]] = None,
    grad_clip: bool = False,
    grad_clip_norm: float = 1.0,
    grad_clip_norm_warmup: float = 10.0,
    warmup_steps: int = 0,
    freeze_translator: bool = False,
    freeze_translator_start_step: int = 0,
    target_stats: Optional[Mapping[str, tuple]] = None,
    loss_dtype: torch.dtype = torch.float32,
) -> Callable:
    """Build ``train_step(state, images, targets, loss_masks=None) -> (state, metrics)``.

    ``state`` is a ``TrainState`` over ``model``'s parameters; the step
    updates them and the optimizer state in place (the JAX step returns new
    ones) and returns the same ``state``. Reference semantics:
      - grad clip at ``grad_clip_norm_warmup`` while ``state.step <
        warmup_steps``, then ``grad_clip_norm``, if ``grad_clip``;
      - the translator freezes from ``freeze_translator_start_step``, and a
        teacher whose ``loss_masks`` entry is 0 leaves its head untouched:
        parameters, Adam moments and per-parameter step counts (``tx`` must
        take ``mask=``, as ``MaskedAdamW`` does). Both are device tensors,
        so a step never waits on the host.
    """

    def train_step(state: TrainState, images: Any, targets: Mapping[str, torch.Tensor], loss_masks=None):
        names = list(state.params)
        preds = model(images)
        losses = get_loss(
            preds, prepare_targets(targets, target_stats, dtype=loss_dtype),
            target_loss_weights, loss_masks, compute_dtype=loss_dtype,
        )
        main = main_loss_from_terms(losses, main_loss)
        found = torch.autograd.grad(main, [state.params[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(state.params[n]) if g is None else g for n, g in zip(names, found)}
        metrics = _metrics(main, losses)

        if grad_clip:
            max_norm = torch.where(state.step < warmup_steps, grad_clip_norm_warmup, grad_clip_norm)
            grads, metrics["grad_norm"] = clip_grad_norm(grads, max_norm)

        update_mask = None
        if loss_masks is not None or freeze_translator:
            device = state.step.device
            unfrozen = (state.step < freeze_translator_start_step).float() if freeze_translator else None
            heads = {
                f"translator.translator_heads.{head_key(t)}.": torch.as_tensor(m, dtype=torch.float32, device=device)
                for t, m in (loss_masks or {}).items()
            }
            update_mask = {}
            for n in names:
                if not n.startswith("translator."):
                    continue
                m = unfrozen
                for prefix, hm in heads.items():
                    if n.startswith(prefix):
                        m = hm if m is None else m * hm
                if m is not None:
                    update_mask[n] = m
        tx.update(grads, state.opt_state, state.params, mask=update_mask)
        state.step += 1
        return state, metrics

    return train_step


def make_eval_step(
    model: nn.Module,
    *,
    main_loss: str = "cos_l1",
    target_loss_weights: Optional[Mapping[str, float]] = None,
    target_stats: Optional[Mapping[str, tuple]] = None,
    loss_dtype: torch.dtype = torch.float32,
) -> Callable:
    """``eval_step(images, targets) -> metrics`` with the model's current
    parameters (the JAX step takes them as its first argument)."""

    @torch.no_grad()
    def eval_step(images: Any, targets: Mapping[str, torch.Tensor]) -> dict[str, Any]:
        losses = get_loss(
            model(images), prepare_targets(targets, target_stats, dtype=loss_dtype),
            target_loss_weights, compute_dtype=loss_dtype,
        )
        return _metrics(main_loss_from_terms(losses, main_loss), losses)

    return eval_step
