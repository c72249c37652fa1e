"""Metrics: meters and optional wandb / TensorBoard writers (port of theia_tpu/utils/logging.py).

Reference semantics (src/theia/utils/logging.py): an AverageMeter per
{mode} x {mse, cos, l1} x {teacher}; train metrics logged every
``log_interval`` steps, eval averages once an epoch; a writer on process 0
only. Every record also goes to ``<log_dir>/<run>.metrics.jsonl`` with the
JAX package's schema. The train loop sums metrics on the device and reads
them back once a log window, so the values given here are host floats.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


class AverageMeter:
    """val/avg/sum/count meter (reference logging.py:18-90)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1) -> None:
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def create_meters(target_model_names: list[str]) -> dict[str, AverageMeter]:
    """Meters per mode x loss (+ per-teacher) (reference logging.py:93-112)."""
    meters: dict[str, AverageMeter] = {}
    for loss in ("mse", "cos", "l1"):
        meters[f"train_{loss}_loss"] = AverageMeter(f"train_{loss}_loss")
        meters[f"eval_{loss}_loss"] = AverageMeter(f"eval_{loss}_loss")
    for t in target_model_names:
        for loss in ("mse", "cos", "l1"):
            for mode in ("train", "eval"):
                meters[f"{mode}_{t}_{loss}_loss"] = AverageMeter(f"{mode}_{t}_{loss}_loss")
    return meters


class MetricLogger:
    """Writes metrics to a JSONL file and, if asked and installed, wandb and TensorBoard."""

    def __init__(
        self,
        log_dir: str,
        run_name: str,
        use_wandb: bool = False,
        use_tensorboard: bool = False,
        project: str = "theia",
        config: Optional[dict] = None,
        enabled: bool = True,
    ) -> None:
        self.enabled = enabled
        self._wandb = None
        self._tb = None
        self._jsonl = None
        if not enabled:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, f"{run_name}.metrics.jsonl"), "a")
        if use_wandb:
            try:
                import wandb

                wandb.init(project=project, name=run_name, config=config)
                self._wandb = wandb
            except ImportError:
                pass
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(os.path.join(log_dir, run_name))
            except ImportError:
                pass

    def log(self, metrics: dict[str, float], step: int) -> None:
        if not self.enabled:
            return
        if self._jsonl is not None:
            self._jsonl.write(json.dumps({"step": step, "ts": time.time(), **metrics}) + "\n")
            self._jsonl.flush()
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._jsonl is not None:
            self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def update_meters_from_metrics(
    meters: dict[str, AverageMeter],
    metrics: dict[str, Any],
    target_model_names: list[str],
    mode: str,
    batch_size: int,
) -> dict[str, float]:
    """Update meters from host metrics (floats, or CPU scalar tensors); returns
    the flat scalar dict for the writers (reference log_metrics; logging.py:115-152)."""
    out: dict[str, float] = {}
    for loss in ("mse", "cos", "l1"):
        v = float(metrics[f"{loss}_loss"])
        meters[f"{mode}_{loss}_loss"].update(v, n=batch_size)
        out[f"{loss}_loss"] = v
        out[f"avg_{mode}_{loss}_loss"] = meters[f"{mode}_{loss}_loss"].avg
    if "loss" in metrics:
        out["loss"] = float(metrics["loss"])
    for t in target_model_names:
        for loss in ("mse", "cos", "l1"):
            per = metrics.get(f"{loss}_losses_per_model", {})
            if t in per:
                v = float(per[t])
                meters[f"{mode}_{t}_{loss}_loss"].update(v, n=batch_size)
                out[f"avg_{mode}_{t}_{loss}_loss"] = meters[f"{mode}_{t}_{loss}_loss"].avg
    return out
