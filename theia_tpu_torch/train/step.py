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

Tensor parallelism: on a model cut by ``parallel.tp.shard_module`` over a
(data, model) grid, the targets of the predictions whose features stay
split are sliced to the rank's features, the loss sums its split parts over
the model group, and the gradients go in two float32 buckets: the split
parameters' averaged over the data group, the replicated parameters'
averaged over the whole world (the data group's mean, and the model
group's copies made one, should the device's rounding set them apart, so
that the replicated parameters stay bit-equal across the model group). A bf16 wire
warns and stays float32, as the JAX step does under a model axis. The grad
clip's norm sums the split gradients' squares over the model group and
counts the replicated ones once; the metrics are averaged over the data
group.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
from theia_tpu_torch.models.translators import head_key
from theia_tpu_torch.parallel.distributed import all_reduce, world_size
from theia_tpu_torch.parallel.mesh import Grid
from theia_tpu_torch.parallel.tp import split_outputs
from theia_tpu_torch.train.optim import clip_grad_norm
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.utils.profiling import span

_TERMS = ("mse_loss", "cos_loss", "l1_loss")
_PER_MODEL = ("mse_losses_per_model", "cos_losses_per_model", "l1_losses_per_model")


def prepare_targets(
    targets: Mapping[str, torch.Tensor],
    target_stats: Optional[Mapping[str, tuple]] = None,
    dtype: torch.dtype = torch.float32,
    split: Optional[Mapping[str, Grid]] = None,
) -> dict[str, torch.Tensor]:
    """Raw [B, C, H, W] teacher features -> [B, H*W, C] in ``dtype``, then
    (x - mean) / std where ``target_stats`` has the teacher; on the device.
    ``split``: teacher -> grid for the targets of predictions whose features
    (the last dimension) the grid's model group splits; each keeps the
    rank's slice of its features, and of its statistics.

    The transpose (and slice) is made in the same copy as the cast, so the
    result is contiguous: the fused loss reads it as [B, D] rows without a
    copy of its own (``ops.fused_loss.flat_rows``)."""
    out = {}
    for t, arr in targets.items():
        if arr.ndim == 4:
            b, c = arr.shape[:2]
            arr = arr.reshape(b, c, -1).transpose(1, 2)
        grid = (split or {}).get(t)
        arr = _features_of_rank(arr, grid).to(dtype, memory_format=torch.contiguous_format)
        if target_stats is not None and t in target_stats:
            mean, std = target_stats[t]
            if mean is not None:
                mean, std = (_features_of_rank(torch.as_tensor(v, dtype=dtype, device=arr.device), grid)
                             for v in (mean, std))
                arr = (arr - mean) / std
        out[t] = arr
    return out


def _features_of_rank(x: torch.Tensor, grid: Optional[Grid]) -> torch.Tensor:
    """The model rank's slice of ``x``'s last dimension (a view); ``x`` itself without a grid."""
    if grid is None:
        return x
    width = x.shape[-1] // grid.n_model
    return x.narrow(-1, grid.model_index * width, width)


def _metrics(main: torch.Tensor, losses: Mapping[str, Any]) -> dict[str, Any]:
    metrics: dict[str, Any] = {"loss": main.detach(), **{k: losses[k].detach() for k in _TERMS}}
    for k in _PER_MODEL:
        metrics[k] = {t: v.detach() for t, v in losses[k].items()}
    return metrics


def mean_over_ranks(metrics: dict[str, Any], world: int, group: Optional[dist.ProcessGroup] = None
                    ) -> dict[str, Any]:
    """``metrics`` (scalar tensors, and dicts of them) averaged over the
    ``world`` ranks of ``group`` (None: all) by one float32 ``all_reduce``
    of their stack, on the device; unchanged at one rank."""
    if world <= 1:
        return metrics
    keys: list[tuple[str, Optional[str]]] = []
    leaves: list[torch.Tensor] = []
    for k, v in metrics.items():
        for sub, leaf in (v.items() if isinstance(v, dict) else [(None, v)]):
            keys.append((k, sub))
            leaves.append(leaf.float())
    stacked = all_reduce(torch.stack(leaves), group) / world
    out: dict[str, Any] = {}
    for (k, sub), v in zip(keys, stacked):
        if sub is None:
            out[k] = v
        else:
            out.setdefault(k, {})[sub] = v
    return out


def all_reduce_grads(
    grads: dict[str, torch.Tensor], world: int, wire_dtype: Optional[torch.dtype] = None,
    group: Optional[dist.ProcessGroup] = None,
) -> dict[str, torch.Tensor]:
    """The mean of the ``world`` ranks' (of ``group``; None: all) ``grads``,
    by one ``all_reduce`` of their flat buffer: each gradient in float32,
    scaled by 1/world, cast to ``wire_dtype`` (None: float32), summed over
    ranks and cast back, then split into the parameters' shapes and dtypes."""
    if not grads:
        return {}
    flat = torch.cat([g.reshape(-1).float() for g in grads.values()])
    flat.div_(world)
    wire = flat if wire_dtype in (None, torch.float32) else flat.to(wire_dtype)
    flat = all_reduce(wire, group).float()
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
    rows of the global batch (of its data index, on a cut model).

    Inside ``utils.profiling.recording()`` each call records a span
    ``step`` whose children partition it: ``step.forward``, ``step.loss``,
    ``step.backward``, ``step.reduce`` (more than one rank, or a cut model),
    ``step.clip`` (``grad_clip``) and ``step.optimizer`` (the update mask
    and ``tx.update``), each with the call's host-side count as its unit.
    """
    world = world_size()
    layout = getattr(model, "tp_layout", None)
    split = split_outputs(model)
    if layout is not None and grad_allreduce_dtype not in (None, torch.float32):
        warnings.warn(f"grad_allreduce_dtype is only supported without a model axis (model axis is "
                      f"{layout.grid.n_model}); keeping the float32 gradient all-reduce.")
        grad_allreduce_dtype = None

    calls = 0  # the host-side count that identifies a step's spans (state.step lives on the device)

    def train_step(state: TrainState, images: Any, targets: Mapping[str, torch.Tensor], loss_masks=None):
        nonlocal calls
        unit, calls = calls, calls + 1
        with span("step", unit):
            names = list(state.params)
            with span("step.forward", unit):
                preds = model(images)
            with span("step.loss", unit):
                losses = get_loss(
                    preds, prepare_targets(targets, target_stats, dtype=loss_dtype, split=split),
                    target_loss_weights, loss_masks, compute_dtype=loss_dtype, split=split,
                )
                main = main_loss_from_terms(losses, main_loss)
                metrics = _metrics(main, losses)
            with span("step.backward", unit):
                found = torch.autograd.grad(main, [state.params[n] for n in names], allow_unused=True)
                grads = {n: torch.zeros_like(state.params[n]) if g is None else g for n, g in zip(names, found)}
            if layout is not None or world > 1:
                with span("step.reduce", unit):
                    if layout is not None:
                        grads, metrics = _reduce_over_grid(grads, metrics, layout)
                    else:
                        grads = all_reduce_grads(grads, world, grad_allreduce_dtype)
                        metrics = mean_over_ranks(metrics, world)

            if grad_clip:
                with span("step.clip", unit):
                    max_norm = torch.where(state.step < warmup_steps, grad_clip_norm_warmup, grad_clip_norm)
                    grads, metrics["grad_norm"] = clip_grad_norm(grads, max_norm, layout)

            with span("step.optimizer", unit):
                update_mask = None
                if loss_masks is not None or freeze_translator:
                    device = state.step.device
                    unfrozen = (state.step < freeze_translator_start_step).float() if freeze_translator else None
                    heads = {
                        f"translator.translator_heads.{head_key(t)}.": torch.as_tensor(m, dtype=torch.float32,
                                                                                        device=device)
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


def _reduce_over_grid(grads: dict[str, torch.Tensor], metrics: dict[str, Any], layout) -> tuple[dict, dict]:
    """A cut model's gradients and metrics averaged over its grid: the split
    parameters' gradients over the data group, the replicated ones' over
    the world, the metrics over the data group (all float32)."""
    grid = layout.grid
    split = {n: g for n, g in grads.items() if layout.is_split(n)}
    if grid.n_data > 1:
        split = all_reduce_grads(split, grid.n_data, group=grid.data_group)
        metrics = mean_over_ranks(metrics, grid.n_data, grid.data_group)
    replicated = all_reduce_grads({n: g for n, g in grads.items() if n not in split}, grid.world)
    return {n: split[n] if n in split else replicated[n] for n in grads}, metrics


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
    process group, the metrics are averaged over the ranks (over the data
    group, on a cut model)."""
    world, group = world_size(), None
    layout = getattr(model, "tp_layout", None)
    if layout is not None:
        world, group = layout.grid.n_data, layout.grid.data_group
    split = split_outputs(model)

    @torch.no_grad()
    def eval_step(images: Any, targets: Mapping[str, torch.Tensor]) -> dict[str, Any]:
        losses = get_loss(
            model(images), prepare_targets(targets, target_stats, dtype=loss_dtype, split=split),
            target_loss_weights, compute_dtype=loss_dtype, split=split,
        )
        return mean_over_ranks(_metrics(main_loss_from_terms(losses, main_loss), losses), world, group)

    return eval_step
