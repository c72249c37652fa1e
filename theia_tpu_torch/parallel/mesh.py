"""The ("data", "model") grid of processes (port of theia_tpu/parallel/mesh.py).

The JAX package lays one mesh over every chip, ``np.asarray(devices)
.reshape(n_data, n_model)`` (theia_tpu/parallel/mesh.py:20-32). The port
runs one process a card, so the grid is one of ranks, laid out the same
way: rank r sits at data index ``r // n_model`` and model index
``r % n_model``. The ranks of one data index form a model group (they hold
one replica of the model, split over them by ``parallel/tp.py``, and read
the same rows); the ranks of one model index form a data group (they hold
the same slices of the parameters and average their gradients).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch.distributed as dist

from theia_tpu_torch.parallel.distributed import rank as _rank
from theia_tpu_torch.parallel.distributed import world_size as _world_size


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in the (data, model) grid and its two groups: None
    where the group is this rank alone, the world's group where it is the
    whole world."""

    n_data: int
    n_model: int
    data_index: int
    model_index: int
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def world(self) -> int:
        return self.n_data * self.n_model


def make_grid(n_model: int = 1) -> Grid:
    """The grid of the process group ``init_distributed`` made (or of this
    process alone), with ``n_model`` ranks a model group.

    Every rank must call it, with the same ``n_model``: ``dist.new_group``
    is a collective over the world. A world of one makes no group, nor does
    ``n_model = 1`` (the data group is then the world's). Raises
    ``ValueError`` where ``n_model`` does not divide the world."""
    world, rank = _world_size(), _rank()
    if n_model < 1 or world % n_model:
        raise ValueError(f"training.model_axis={n_model} must divide the world of {world} processes")
    n_data = world // n_model
    data_group = model_group = None
    if world > 1 and n_model == 1:
        data_group = dist.group.WORLD
    elif world > 1:
        for d in range(n_data):
            g = dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
            if d == rank // n_model:
                model_group = g
        for m in range(n_model):
            g = dist.new_group(list(range(m, world, n_model)))
            if m == rank % n_model and n_data > 1:
                data_group = g
    return Grid(n_data, n_model, rank // n_model, rank % n_model, data_group, model_group)
