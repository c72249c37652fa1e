"""Data parallelism over processes (port of theia_tpu/parallel/distributed.py
and the data-parallel half of theia_tpu/parallel/mesh.py)."""

from theia_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_module,
    init_distributed,
    is_main_process,
    rank,
    world_size,
)

__all__ = ["barrier", "broadcast_module", "init_distributed", "is_main_process", "rank", "world_size"]
