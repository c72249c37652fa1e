"""One process per GPU, started by torchrun (port of
theia_tpu/parallel/distributed.py:17-35 and the data-parallel half of
theia_tpu/parallel/mesh.py:20-52).

The JAX package lays one ("data", "model") mesh over every chip and lets
the SPMD partitioner emit the gradient all-reduce; the reference runs one
process per GPU under torchrun with NCCL (src/theia/scripts/train/
train_rvfm.py:211-229). The port does what the reference does: each
process trains on its own card (``cuda:LOCAL_RANK``) and its own rows of
the global batch, and the train step all-reduces the gradients by hand
(``train/step.py``). This module holds the process group's set-up, the
rank arithmetic, a barrier and the rank-0 broadcast of a module's
parameters and buffers, which plays the part of the JAX package's
replicated ``device_put`` (theia_tpu/train/loop.py:301-303). Every
collective the port issues goes through ``all_reduce``, ``all_gather``,
``broadcast`` or ``broadcast_object`` here, which note it for
``parallel/audit.py``.

Launch:
    torchrun --nproc_per_node=N -m theia_tpu_torch.scripts.train_rvfm [overrides...]
torchrun sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``; without ``WORLD_SIZE`` (or with ``WORLD_SIZE=1``) the
process trains alone and no process group is made.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch
import torch.distributed as dist
from torch import nn

from theia_tpu_torch.parallel import audit

_TORCHRUN_VARS = ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def world_size() -> int:
    """Processes in the group; 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank; 0 without a group."""
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return rank() == 0


def init_distributed(device: torch.device | str = "cuda", backend: Optional[str] = None) -> tuple[int, int, torch.device]:
    """Join the process group torchrun describes; returns (rank, world size,
    device).

    With no ``WORLD_SIZE`` or ``WORLD_SIZE=1`` and no group already made,
    nothing happens: (0, 1, ``device``). Otherwise the group is made from
    torchrun's variables (NCCL for a CUDA device, gloo for the CPU, unless
    ``backend`` names one: gloo also takes CUDA tensors, which lets several
    processes share one card), and a CUDA ``device`` becomes
    ``cuda:LOCAL_RANK``, made the current device. A group made before the
    call is kept as it is."""
    device = torch.device(device)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), _local_device(device)
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world <= 1:
        return 0, 1, device
    missing = [k for k in _TORCHRUN_VARS if not os.environ.get(k)]
    if missing:
        raise ValueError(f"WORLD_SIZE={world} but {', '.join(missing)} unset: launch with torchrun, "
                         "which sets RANK, LOCAL_RANK, MASTER_ADDR and MASTER_PORT")
    device = _local_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    kwargs = {}
    if backend == "nccl":
        kwargs["device_id"] = device  # binds the communicator to this process's card
    dist.init_process_group(backend, init_method="env://", world_size=world, rank=int(os.environ["RANK"]), **kwargs)
    return dist.get_rank(), dist.get_world_size(), device


def _local_device(device: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:LOCAL_RANK`` (made current); any other device as it is."""
    if device.type != "cuda" or device.index is not None:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return device
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0") or 0))
    torch.cuda.set_device(local)
    return local


def barrier() -> None:
    """Wait for every process of the group; nothing without one."""
    if world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def group_size(group: Optional[dist.ProcessGroup] = None) -> int:
    """Ranks in ``group`` (None: the world)."""
    return dist.get_world_size(group)


def all_reduce(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
               op: Any = dist.ReduceOp.SUM) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group`` (None: the
    world), noted for the audit; returns ``t``."""
    audit.record("all-reduce", t.numel() * t.element_size(), group_size(group))
    dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t: torch.Tensor, group: Optional[dist.ProcessGroup] = None) -> list[torch.Tensor]:
    """Every rank's ``t`` (one shape on all ranks), in rank order of
    ``group``, noted for the audit with the gathered bytes."""
    n = group_size(group)
    out = [torch.empty_like(t) for _ in range(n)]
    audit.record("all-gather", n * t.numel() * t.element_size(), n)
    dist.all_gather(out, t.contiguous(), group=group)
    return out


def broadcast(t: torch.Tensor, src: int, group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """``dist.broadcast`` of ``t`` in place from global rank ``src``, noted
    for the audit; returns ``t``."""
    audit.record("collective-broadcast", t.numel() * t.element_size(), group_size(group))
    dist.broadcast(t, src, group=group)
    return t


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s picklable ``obj`` on every rank of the world."""
    box = [obj]
    audit.record("collective-broadcast", 0, group_size())
    dist.broadcast_object_list(box, src=src)
    return box[0]


@torch.no_grad()
def broadcast_module(module: nn.Module, src: int = 0) -> None:
    """Copy rank ``src``'s parameters and buffers into every rank's
    ``module``, in place (the replicated placement of the JAX loop). Run
    once after the model is made or restored; nothing without a group."""
    if world_size() <= 1:
        return
    for t in [*module.parameters(), *module.buffers()]:
        broadcast(t.data, src)
