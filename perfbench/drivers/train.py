"""The "train" driver: a closed loop of the recipe's train step, steps back to back.

Set-up draws the parameters, the teachers' statistics and a ring of
distinct batches on the device from the seed, builds the program's model,
its masked AdamW and ``make_train_step`` as ``train/loop.py`` builds them
from the recipe the traffic file states, and drives that same step through
its first ``checked_steps`` steps on distinct batches: they warm up every
shape, and their losses, the first gradient (from Adam's first moment) and
the parameters' change are what the reference is held to. The window then
runs the step on the ring until the time is up and ends in a synchronize.
"""

from __future__ import annotations

import gc
import time
from typing import Optional

import torch

from perfbench import check, inputs, port
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class TimedOptimizer:
    """The program's optimizer, the host's seconds inside its ``update`` summed."""

    def __init__(self, tx) -> None:
        self.tx = tx
        self.seconds = 0.0

    def init(self, params):
        return self.tx.init(params)

    def update(self, *args, **kwargs):
        t0 = time.perf_counter()
        out = self.tx.update(*args, **kwargs)
        self.seconds += time.perf_counter() - t0
        return out


class Driver:
    unit = "steps"

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int, device: torch.device) -> None:
        self.cfg, self.traffic, self.cell, self.seed, self.device = cfg, traffic, cell, seed, device
        self.batch = int(cell["batch"])
        self.recipe = traffic["recipe"]

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from theia_tpu_torch.train.optim import constant_with_warmup, make_optimizer, scaled_lr
        from theia_tpu_torch.train.state import TrainState
        from theia_tpu_torch.train.step import make_train_step

        r, cfg = self.recipe, self.cfg
        gen = inputs.generator(self.seed, self.device)
        self.params0 = ref.make_params(cfg, gen)
        self.stats = inputs.teacher_stats(cfg, gen)
        self.ring = [inputs.train_batch(self.batch, cfg, self.stats, gen) for _ in range(int(self.traffic["ring"]))]
        self.model = port.build(cfg, self.params0, dtype=DTYPES[r["compute_dtype"]], fast_math=r["fast_math"],
                                fuse_preprocessing=r["fuse_preprocessing"])
        lr = scaled_lr(r["base_lr"], self.batch, 1, r["base_batch_size"], r["base_world_size"])
        schedule = constant_with_warmup(lr, ref_train.warmup_steps(r, self.batch), r["warm_up_lr_start_factor"])
        self.tx = TimedOptimizer(make_optimizer(schedule, weight_decay=r["weight_decay"], betas=tuple(r["betas"]),
                                                  eps=r["eps"], translator_lr_factor=r["translator_lr_factor"],
                                                  moment_dtype=DTYPES.get(r["moment_dtype"])))
        self.state = TrainState.create(dict(self.model.named_parameters()), self.tx)
        self.step_fn = make_train_step(self.model, self.tx, main_loss=r["main_loss"], grad_clip=r["grad_clip"],
                                       target_stats=self.stats, loss_dtype=DTYPES[r["loss_dtype"]])
        self.steps_run = 0
        self.prog = self.checked_steps()

    def step(self) -> dict:
        images, raw = self.ring[self.steps_run % len(self.ring)]
        self.state, metrics = self.step_fn(self.state, images, raw)
        self.steps_run += 1
        return metrics

    def checked_steps(self) -> dict:
        """The first steps, read for the comparison: each loss, each
        parameter's first gradient (Adam's first moment after one step over
        1 − β1, kept on the host) and its norm, and its change over the steps."""
        n = int(self.traffic["checked_steps"])
        if n > len(self.ring):
            raise ValueError("the checked steps need as many distinct batches in the ring")
        names = list(self.state.params)
        b1 = self.recipe["betas"][0]
        losses = []
        for k in range(n):
            losses.append(self.step()["loss"])
            if k == 0:
                mu = self.state.opt_state.mu
                grad_norm = torch.stack([mu[name].float().norm() for name in names]) / (1.0 - b1)
                first = {name: (mu[name].float() / (1.0 - b1)).cpu() for name in names}
        change = torch.stack([(self.state.params[name].detach() - self.params0[name]).norm() for name in names])
        sync(self.device)
        return {"names": names, "loss": [float(x) for x in losses], "grad_norm": grad_norm.tolist(),
                "change_norm": change.tolist(), "first_grad": first}

    # ------------------------------------------------------------ the window
    def window(self, seconds: float) -> dict:
        sync(self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        n = 0
        metrics = None
        optimizer_s = self.tx.seconds
        while time.perf_counter() < deadline:
            metrics = self.step()
            n += 1
        sync(self.device)
        elapsed = time.perf_counter() - t0
        failed = 0 if metrics is None or torch.isfinite(metrics["loss"]).item() else 1
        return {"attempted": n, "failed": failed, "done": n, "seconds": elapsed,
                "train_images_per_s": n * self.batch / elapsed,
                "optimizer_ms": 1e3 * (self.tx.seconds - optimizer_s) / n if n else None}

    def run_units(self, units: int) -> None:
        """``units`` more steps, then a synchronize (for a trace)."""
        for _ in range(units):
            self.step()
        sync(self.device)

    def free(self) -> None:
        """Drop the program's model, optimizer state and step."""
        for name in ("step_fn", "state", "tx", "model"):
            setattr(self, name, None)
        self.ring = self.ring[: int(self.traffic["checked_steps"])]
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check
    def reference(self, precision: str = "float32", batch_rows: Optional[int] = None) -> dict:
        """The reference's trajectory over the checked steps' batches;
        ``batch_rows`` keeps only the first rows of each batch."""
        n = int(self.traffic["checked_steps"])
        batches = []
        for images, raw in self.ring[:n]:
            if batch_rows is not None:
                images, raw = images[:batch_rows], {t: x[:batch_rows] for t, x in raw.items()}
            batches.append((images, raw))
        return ref_train.follow(self.params0, batches, self.stats, self.cfg, self.recipe,
                                rows=ref.block_rows(self.cfg), precision=precision, batch=self.batch)

    def compare(self) -> tuple[dict[str, float], dict[str, str]]:
        return check.train_numbers(self.prog, self.reference())
