"""Distillation losses in plain PyTorch (port of theia_tpu/models/losses.py:23-151).

Per-teacher MSE, SmoothL1 (β=1) and the cosine-embedding loss (target +1)
on flattened per-sample features; per-teacher weighting (1/N by default),
the cosine always weighted 1/N; the main loss 0.9·cos + 0.1·l1 (or MSE).
Every term is a device scalar: nothing here reads a value back to the host.
The fused one-pass loss (``_losses_fused``: the five per-sample sums of
``ops.fused_loss.LossSums``, the CUDA kernels K5 forward and K6 backward on
CUDA tensors) takes every teacher whose flattened feature has at least 1024
elements, a multiple of 128 (the JAX selection rule), while ``fused`` is
True; ``fused=None`` means ``FUSED_LOSS``.

Tensor parallelism (``parallel/tp.py``): a prediction whose features stay
split over a model group (``split``) meets its target sliced the same way
(``train.step.prepare_targets``). The fused loss runs K5 on the rank's
slice, sums the five per-sample sums over the group (``reduce_from_model``)
and divides the means by the whole D; K6 then runs on the slice. The other
teachers' loss gathers the prediction and the target whole first. The
selection rule reads the whole D.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from theia_tpu_torch.ops.fused_loss import LossSums, flat_rows
from theia_tpu_torch.parallel.mesh import Grid
from theia_tpu_torch.parallel.tp import gather_from_model, reduce_from_model

# get_loss(fused=None): True runs the one-pass loss (K5/K6 on CUDA tensors,
# their plain versions on CPU tensors; the port's default, as attention's
# and LayerNormSpatial's kernels are); False the separate PyTorch reductions.
# The JAX package resolves None to False.
FUSED_LOSS = True


def mse_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return (pred - target).square().mean(dtype=torch.float32)


def smooth_l1_loss(pred: torch.Tensor, target: torch.Tensor, beta: float = 1.0) -> torch.Tensor:
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean(dtype=torch.float32)


def cosine_loss(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """CosineEmbeddingLoss with target +1 over flattened per-sample features,
    in the dot form sum(p·t) / (max(|p|, eps) · max(|t|, eps))."""
    p = pred.reshape(pred.shape[0], -1)
    t = target.reshape(target.shape[0], -1)
    s_pt = (p * t).sum(dim=1, dtype=torch.float32)
    s_pp = (p * p).sum(dim=1, dtype=torch.float32)
    s_tt = (t * t).sum(dim=1, dtype=torch.float32)
    denom = s_pp.sqrt().clamp_min(eps) * s_tt.sqrt().clamp_min(eps)
    return (1.0 - s_pt / denom).mean()


def _loss_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """x as the fused loss reads it in ``dtype``: a bf16 tensor stays bf16
    (the kernels and their plain version compute in float32, so reading
    bf16 is the exact cast to float32, without a float32 copy); anything
    else is cast."""
    return x if x.dtype == torch.bfloat16 else x.to(dtype)


def _losses_fused(pred: torch.Tensor, target: torch.Tensor, compute_dtype: torch.dtype, eps: float = 1e-12,
                  grid: Optional[Grid] = None):
    """(mse, l1, cos) from the five per-sample sums of one pass (K5, K6);
    with ``grid``, of the slices of the features the model group splits."""
    p = flat_rows(_loss_input(pred, compute_dtype))
    t = flat_rows(_loss_input(target, compute_dtype).detach())
    d = p.shape[1]
    sums = LossSums.apply(p, t, 1.0)
    if grid is not None:
        sums = reduce_from_model(sums, grid)
        d *= grid.n_model
    mse = sums[:, 0].mean() / d
    l1 = sums[:, 1].mean() / d
    denom = sums[:, 3].sqrt().clamp_min(eps) * sums[:, 4].sqrt().clamp_min(eps)
    cos = (1.0 - sums[:, 2] / denom).mean()
    return mse, l1, cos


def get_loss(
    pred_features: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    target_loss_weights: Optional[Mapping[str, float] | float] = None,
    loss_masks: Optional[Mapping[str, Any]] = None,
    fused: Optional[bool] = None,
    compute_dtype: torch.dtype = torch.float32,
    split: Optional[Mapping[str, Grid]] = None,
) -> dict[str, Any]:
    """Distillation loss terms for every predicted teacher.

    ``loss_masks``: optional per-teacher {0, 1} scalars (floats or tensors);
    masked teachers add nothing and the averages divide by the number of
    active ones (at least 1). ``compute_dtype``: the elementwise dtype of
    the loss terms; the reductions accumulate in float32 either way.
    ``fused``: the one-pass loss for the teachers the JAX rule selects
    (None: ``FUSED_LOSS``). ``split``: teacher -> grid for the predictions
    (and targets) whose last dimension is split over the grid's model group.
    """
    if fused is None:
        fused = FUSED_LOSS
    names = list(pred_features)
    device = pred_features[names[0]].device
    zero = torch.zeros((), dtype=torch.float32, device=device)
    masks = None
    if loss_masks is not None:
        masks = {t: torch.as_tensor(loss_masks[t], dtype=torch.float32, device=device) for t in names}
        n_active = torch.stack(list(masks.values())).sum().clamp_min(1.0)
    else:
        n_active = float(len(names))
    mse_avg, cos_avg, l1_avg = zero, zero, zero
    mse_per, cos_per, l1_per = {}, {}, {}
    for t in names:
        grid = (split or {}).get(t)
        d_flat = pred_features[t][0].numel() * (1 if grid is None else grid.n_model)
        if fused and d_flat >= 1024 and d_flat % 128 == 0:
            mse, l1, cos = _losses_fused(pred_features[t], targets[t], compute_dtype, grid=grid)
        else:
            pred, target = pred_features[t], targets[t]
            if grid is not None:
                pred, target = gather_from_model(pred, grid), gather_from_model(target.detach(), grid)
            pred = pred.to(compute_dtype)
            target = target.to(compute_dtype)
            mse, l1, cos = mse_loss(pred, target), smooth_l1_loss(pred, target), cosine_loss(pred, target)
        if target_loss_weights is None:
            weight = 1.0 / n_active
        elif isinstance(target_loss_weights, Mapping):
            weight = target_loss_weights[t]
        else:
            weight = target_loss_weights
        mask = 1.0 if masks is None else masks[t]
        mse_avg = mse_avg + mse * weight * mask
        cos_avg = cos_avg + cos * mask / n_active  # cos always balanced
        l1_avg = l1_avg + l1 * weight * mask
        mse_per[t], cos_per[t], l1_per[t] = mse, cos, l1
    return {
        "mse_loss": mse_avg,
        "cos_loss": cos_avg,
        "l1_loss": l1_avg,
        "mse_losses_per_model": mse_per,
        "cos_losses_per_model": cos_per,
        "l1_losses_per_model": l1_per,
    }


def main_loss_from_terms(losses: Mapping[str, Any], main_loss: Optional[str]) -> torch.Tensor:
    """The reference's main-loss selection: "mse" (or None) or "cos_l1"."""
    if main_loss == "mse" or main_loss is None:
        return losses["mse_loss"]
    if main_loss == "cos_l1":
        return 0.9 * losses["cos_loss"] + 0.1 * losses["l1_loss"]
    raise NotImplementedError(f"main_loss {main_loss} is not implemented.")
