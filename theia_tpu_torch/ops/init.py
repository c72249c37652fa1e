"""Parameter initializers drawn from an explicit ``torch.Generator``.

Port of theia_tpu/ops/init.py: the same distributions, not the same numbers
(a ``jax.random`` key and a torch generator give different streams; the
parity tests copy JAX parameters across instead).

- HF ViT modules: ``torch.nn.init.trunc_normal_(std=0.02)``, whose bounds
  ±2.0 are absolute (±100σ), for weights, position embeddings and special
  tokens; zero bias; LayerNorm ones/zeros (``ViTBackbone.reset_parameters``).
- Translator heads are plain torch modules upstream, so they get torch's
  defaults: U(±1/sqrt(fan_in)) for weights and biases (below).
"""

from __future__ import annotations

import math
from typing import Optional

import torch


@torch.no_grad()
def uniform_fan_in_(
    t: torch.Tensor, fan_in: int, generator: Optional[torch.Generator] = None
) -> torch.Tensor:
    """torch's default Linear/Conv init: kaiming_uniform(a=√5) == U(±1/√fan_in)."""
    bound = 1.0 / math.sqrt(fan_in)
    return t.uniform_(-bound, bound, generator=generator)
