"""The recipe's train step in plain PyTorch: targets normalised on the
device, the cos_l1 distillation loss over every teacher, the gradients,
and masked AdamW (decay on parameters of ndim > 1 that are not biases,
bias-corrected moments in float32, the linear-warmup learning rate).

``follow`` runs the reference's own trajectory from the initial parameters
over the batches it is given and returns what the benchmark compares: the
loss of every step, each parameter's first gradient norm, and each
parameter's change after the last step. The gradient of a step is summed
over blocks of rows, so that a large batch fits beside nothing else.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from perfbench.reference import model as ref


def normalise_targets(raw: dict[str, torch.Tensor], stats: dict[str, tuple[torch.Tensor, torch.Tensor]]
                      ) -> dict[str, torch.Tensor]:
    """Raw [B, C, H, W] features -> float32 [B, H·W, C], (x - mean) / std a channel."""
    out = {}
    for t, x in raw.items():
        b, c = x.shape[:2]
        mean, std = stats[t]
        out[t] = (x.float().reshape(b, c, -1).transpose(1, 2) - mean) / std
    return out


def sample_losses(preds: dict[str, torch.Tensor], targets: dict[str, torch.Tensor]) -> torch.Tensor:
    """Each sample's cos_l1 loss: the mean over teachers of 0.9 · (1 − cos)
    + 0.1 · mean smooth-L1 (β = 1) over the flattened features."""
    total = 0.0
    for t, p in preds.items():
        p = p.reshape(p.shape[0], -1).float()
        y = targets[t].reshape(p.shape[0], -1)
        cos = (p * y).sum(1) / (p.norm(dim=1).clamp_min(1e-12) * y.norm(dim=1).clamp_min(1e-12))
        d = (p - y).abs()
        l1 = torch.where(d < 1.0, 0.5 * d * d, d - 0.5).mean(1)
        total = total + 0.9 * (1.0 - cos) + 0.1 * l1
    return total / len(preds)


def learning_rate(recipe: dict, batch: int, step: int) -> float:
    """The recipe's scaled rate with linear warmup from ``warm_up_lr_start_factor``."""
    lr = recipe["base_lr"] * batch / (recipe["base_batch_size"] * recipe["base_world_size"])
    warm = warmup_steps(recipe, batch)
    f = recipe["warm_up_lr_start_factor"]
    return lr * (f + (1.0 - f) * min(step / max(warm, 1), 1.0)) if step < warm else lr


def warmup_steps(recipe: dict, batch: int) -> int:
    """The loop's warmup: a ratio of the run's steps over the data set's images at one rank."""
    steps_per_epoch = math.ceil(recipe["dataset_images"] / batch)
    return int(recipe["warm_up_steps_ratio"] * steps_per_epoch * recipe["epochs"])


def loss_and_grads(params: dict[str, torch.Tensor], images: torch.Tensor, raw: dict[str, torch.Tensor],
                   stats: dict, cfg: dict, recipe: dict, rows: int, precision: str
                   ) -> tuple[float, dict[str, torch.Tensor]]:
    """The batch's mean loss and its gradient, summed over blocks of ``rows`` samples."""
    b = images.shape[0]
    names = list(params)
    leaves = [params[n] for n in names]
    grads = [torch.zeros_like(p) for p in leaves]
    total = 0.0
    for s in range(0, b, rows):
        targets = normalise_targets({t: x[s:s + rows] for t, x in raw.items()}, stats)
        preds = ref.predict(params, images[s:s + rows], cfg, fused=recipe["fuse_preprocessing"],
                            tanh_gelu=recipe["fast_math"], precision=precision)
        loss = sample_losses(preds, targets).sum() / b
        for acc, g in zip(grads, torch.autograd.grad(loss, leaves, allow_unused=True)):
            if g is not None:
                acc.add_(g)
        total += float(loss.detach())
    return total, dict(zip(names, grads))


def follow(params0: dict[str, torch.Tensor], batches: list[tuple[torch.Tensor, dict]], stats: dict, cfg: dict,
           recipe: dict, *, rows: int, precision: str = "float32", batch: Optional[int] = None) -> dict:
    """The reference's steps from ``params0`` over ``batches`` (images, raw
    targets). ``batch`` is the batch size the learning rate is scaled by
    (default: the batches' own). Returns {"loss": [a step], "grad_norm":
    [a leaf], "change_norm": [a leaf], "names": [...], "first_grad": {name:
    tensor}}."""
    b1, b2 = recipe["betas"]
    eps, wd = recipe["eps"], recipe["weight_decay"]
    batch = batch or batches[0][0].shape[0]
    names = list(params0)
    params = {n: p.detach().clone().float().requires_grad_(True) for n, p in params0.items()}
    m = {n: torch.zeros_like(p) for n, p in params.items()}
    v = {n: torch.zeros_like(p) for n, p in params.items()}
    losses, grad_norm = [], None
    with ref.precision_flags(precision):
        for k, (images, raw) in enumerate(batches):
            loss, grads = loss_and_grads(params, images, raw, stats, cfg, recipe, rows, precision)
            losses.append(loss)
            if grad_norm is None:
                grad_norm = [float(grads[n].norm()) for n in names]
                first_grad = {n: g.detach().clone() for n, g in grads.items()}
            lr = learning_rate(recipe, batch, k)
            with torch.no_grad():
                for n in names:
                    p, g = params[n], grads[n]
                    m[n].mul_(b1).add_(g, alpha=1 - b1)
                    v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                    upd = (m[n] / (1 - b1 ** (k + 1))) / ((v[n] / (1 - b2 ** (k + 1))).sqrt() + eps)
                    if p.ndim > 1 and not n.endswith("bias"):
                        upd = upd + wd * p
                    p.sub_(lr * upd)
    change = [float((params[n].detach() - params0[n].float()).norm()) for n in names]
    return {"names": names, "loss": losses, "grad_norm": grad_norm, "change_norm": change, "first_grad": first_grad}
