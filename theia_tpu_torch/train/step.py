"""The distillation train and eval steps (port of theia_tpu/train/step.py:49-71,74-268,348-377).

uint8 images and raw teacher features go in; the step runs the model, the
loss, the gradients, the optional grad clip and the masked AdamW update on
the device, and returns metrics as device tensors (nothing is read back to
the host inside a step).

Data parallelism: in a process group of more than one rank (one process a
card, ``parallel/distributed.py``), each rank differentiates its own rows
of the global batch and the step averages the gradients by hand, as the
JAX step's bf16 bucket does (theia_tpu/train/step.py:134-196): the
gradients, zero-filled where a parameter got none, are flattened in
parameter order into one float32 buffer, scaled by 1/world, cast to the
wire dtype (``grad_allreduce_dtype``: bf16, or None for float32), summed
by **one** ``all_reduce``, and cast back to float32 before the grad clip
and the optimizer. The loss and its terms are averaged over ranks by one
more small float32 ``all_reduce`` (the JAX ``pmean``), kept on the device.
At one rank the step issues no collective. (``torch.distributed``'s
``bf16_compress_hook`` casts before it divides, which rounds otherwise;
and ``DistributedDataParallel``'s reducer never sees ``autograd.grad``.)
Left out with the JAX package's TPU and mesh toggles: ``mesh=``,
``donate``, ``compiler_options`` and ``DEFAULT_COMPILER_OPTIONS``.
"""

from __future__ import annotations

from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
from theia_tpu_torch.models.translators import head_key
from theia_tpu_torch.parallel.distributed import world_size
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


def mean_over_ranks(metrics: dict[str, Any], world: int) -> dict[str, Any]:
    """``metrics`` (scalar tensors, and dicts of them) averaged over the
    ``world`` ranks by one float32 ``all_reduce`` of their stack, on the
    device; unchanged at one rank."""
    if world <= 1:
        return metrics
    keys: list[tuple[str, Optional[str]]] = []
    leaves: list[torch.Tensor] = []
    for k, v in metrics.items():
        for sub, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            keys.append((k, sub))
            leaves.append(leaf.float())
    stacked = torch.stack(leaves)
    dist.all_reduce(stacked)
    stacked = stacked / world
    out: dict[str, Any] = {}
    for (k, sub), v in zip(keys, stacked):
        if sub is None:
            out[k] = v
        else:
            out.setdefault(k, {})[sub] = v
    return out


def all_reduce_grads(
    grads: dict[str, torch.Tensor], world: int, wire_dtype: Optional[torch.dtype] = None
) -> dict[str, torch.Tensor]:
    """The mean of every rank's ``grads``, by one ``all_reduce`` of their
    flat buffer: each gradient in float32, scaled by 1/world, cast to
    ``wire_dtype`` (None: float32), summed over ranks and cast back, then
    split into the parameters' shapes and dtypes."""
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    flat.div_(world)
    wire = flat if wire_dtype in (None, torch.float32) else flat.to(wire_dtype)
    dist.all_reduce(wire)
    flat = wire.float()
    out, offset = {}, 0
    for n, g in grads.items():
        out[n] = flat[offset:offset + g.numel()].view(g.shape).to(g.dtype)
        offset += g.numel()
    return out


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
    grad_allreduce_dtype: Optional[torch.dtype] = None,
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
    In a process group of more than one rank (its size read here), the
    gradients are averaged over the ranks on a ``grad_allreduce_dtype``
    wire (bf16, or None for float32) and the metrics over the ranks, as
    the module docstring says; ``images`` and ``targets`` are this rank's
    rows of the global batch.
    """
    world = world_size()

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
        if world > 1:
            grads = all_reduce_grads(grads, world, grad_allreduce_dtype)
            metrics = mean_over_ranks(metrics, world)

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
    parameters (the JAX step takes them as its first argument); in a
    process group, the metrics are averaged over the ranks."""
    world = world_size()

    @torch.no_grad()
    def eval_step(images: Any, targets: Mapping[str, torch.Tensor]) -> dict[str, Any]:
        losses = get_loss(
            model(images), prepare_targets(targets, target_stats, dtype=loss_dtype),
            target_loss_weights, compute_dtype=loss_dtype,
        )
        return mean_over_ranks(_metrics(main_loss_from_terms(losses, main_loss), losses), world)

    return eval_step
