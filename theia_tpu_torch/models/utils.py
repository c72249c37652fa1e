"""Feature-output handling (port of theia_tpu/models/utils.py:11-43)."""

from __future__ import annotations

from typing import Optional

import torch


def handle_feature_output(
    x: torch.Tensor,
    feature_reduce_method: Optional[str] = None,
    num_discard_tokens: int = 0,
) -> torch.Tensor:
    """Select/reduce transformer output tokens for downstream use.

    Input x: [B, 1+H*W+N, C] (CLS + spatial + N register tokens),
    [B, 1+H*W, C], or [B, H*W, C] for no-CLS backbones.

    feature_reduce_method:
      - "mean_pooling": mean over x[:, 1 : T-num_discard] -> [B, C]
      - "max_pooling":  max  over x[:, 1 : T-num_discard] -> [B, C]
      - "cls":          x[:, 0] -> [B, C]
      - "identity":     x unchanged
      - None:           x[:, 1 : T-num_discard] -> [B, H*W, C]
    """
    t = x.shape[1]
    match feature_reduce_method:
        case "mean_pooling":
            return x[:, 1 : t - num_discard_tokens].mean(dim=1)
        case "max_pooling":
            return x[:, 1 : t - num_discard_tokens].amax(dim=1)
        case "cls":
            return x[:, 0]
        case "identity":
            return x
        case None:
            return x[:, 1 : t - num_discard_tokens]
        case _:
            raise NotImplementedError(
                f"feature_reduce_method {feature_reduce_method} is not implemented."
            )
