"""Host utilities of the port: seeding, metric logging and profiling (``utils/profiling.py``).

The public names are the JAX package's (``theia_tpu/utils/__init__.py``).
"""

from theia_tpu_torch.utils.seed import seed_everything
from theia_tpu_torch.utils.logging import AverageMeter, MetricLogger, create_meters

__all__ = ["seed_everything", "AverageMeter", "MetricLogger", "create_meters"]
