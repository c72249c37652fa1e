"""Inputs made from the seed on the device, in a few large draws:
teacher statistics, training batches (uint8 images and raw bf16 teacher
features) and uint8 image batches for serving."""

from __future__ import annotations

import torch


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2**63)


def teacher_stats(cfg: dict, gen: torch.Generator) -> dict[str, tuple[torch.Tensor, torch.Tensor]]:
    """Per-channel float32 (mean, std) a teacher: mean 0.5·N(0, 1), std U(0.5, 2)."""
    out = {}
    for t, (c, _, _) in cfg["teachers"].items():
        mean = 0.5 * torch.randn(c, generator=gen, device=gen.device)
        std = 0.5 + 1.5 * torch.rand(c, generator=gen, device=gen.device)
        out[t] = (mean, std)
    return out


def images(n: int, cfg: dict, gen: torch.Generator) -> torch.Tensor:
    """uint8 [n, H, W, 3], uniform over 0..255."""
    s = cfg["image_size"]
    return torch.randint(0, 256, (n, s, s, 3), generator=gen, device=gen.device, dtype=torch.uint8)


def train_batch(batch: int, cfg: dict, stats: dict, gen: torch.Generator
                ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """A training batch as the loader hands it in ``feature_norm: device``
    mode: uint8 images and each teacher's raw bf16 [B, C, H, W] feature,
    mean + std · N(0, 1) a channel."""
    raw = {}
    for t, (c, h, w) in cfg["teachers"].items():
        mean, std = stats[t]
        x = torch.randn(batch, c, h, w, generator=gen, device=gen.device)
        raw[t] = x.mul_(std.view(1, c, 1, 1)).add_(mean.view(1, c, 1, 1)).to(torch.bfloat16)
    return images(batch, cfg, gen), raw
