"""Distillation losses in plain PyTorch (port of theia_tpu/models/losses.py:23-151).

Per-teacher MSE, SmoothL1 (β=1) and the cosine-embedding loss (target +1)
on flattened per-sample features; per-teacher weighting (1/N by default),
the cosine always weighted 1/N; the main loss 0.9·cos + 0.1·l1 (or MSE).
Every term is a device scalar: nothing here reads a value back to the host.
The fused one-pass loss (``fused=True``, the Pallas kernels K5 and K6) is
not ported yet.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch


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


def get_loss(
    pred_features: Mapping[str, torch.Tensor],
    targets: Mapping[str, torch.Tensor],
    target_loss_weights: Optional[Mapping[str, float] | float] = None,
    loss_masks: Optional[Mapping[str, Any]] = None,
    fused: Optional[bool] = None,
    compute_dtype: torch.dtype = torch.float32,
) -> dict[str, Any]:
    """Distillation loss terms for every predicted teacher.

    ``loss_masks``: optional per-teacher {0, 1} scalars (floats or tensors);
    masked teachers add nothing and the averages divide by the number of
    active ones (at least 1). ``compute_dtype``: the elementwise dtype of
    the loss terms; the reductions accumulate in float32 either way.
    """
    if fused:
        raise NotImplementedError(
            "get_loss(fused=True) is not ported: the one-pass loss kernels are ROADMAP Queue 2 K5-K6"
        )
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
        pred = pred_features[t].to(compute_dtype)
        target = targets[t].to(compute_dtype)
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
