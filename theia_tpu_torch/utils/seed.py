"""Seeding discipline (port of theia_tpu/utils/seed.py; reference src/theia/utils/seed.py:14-48).

Seeds ``random``, numpy and torch, and returns the seed with a seeded CPU
``torch.Generator`` (the JAX function returns a ``PRNGKey``) for draws that
must not depend on the global RNG, such as the model's initial parameters.
"""

from __future__ import annotations

import os
import random
from typing import Any, Optional

import numpy as np
import torch

MAX_SEED = np.iinfo(np.uint32).max
MIN_SEED = np.iinfo(np.uint32).min


def seed_everything(seed: Optional[Any] = None) -> tuple[int, torch.Generator]:
    if seed is None:
        env_seed = os.environ.get("PL_GLOBAL_SEED")
        try:
            seed = int(env_seed) if env_seed is not None else 0
        except ValueError:
            seed = 0
    elif not isinstance(seed, int):
        seed = int(seed)
    if not (MIN_SEED <= seed <= MAX_SEED):
        seed = 0

    os.environ["PL_GLOBAL_SEED"] = str(seed)
    os.environ["PYTHON_SEED"] = str(seed)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed, torch.Generator().manual_seed(seed)
