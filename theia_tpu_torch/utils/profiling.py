"""Profiling hooks: a torch.profiler trace and a step timer (port of theia_tpu/utils/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that records the host's activity, and the card's where CUDA is available,
  and writes one Chrome/Perfetto trace file (``*.pt.trace.json``) into
  ``logdir``, viewable in Perfetto or TensorBoard's profiler;
- ``StepTimer``: a step and images-per-second meter that leaves out the
  first (build and warm-up) steps.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Profile the block and write its trace into ``logdir``; the profiler
    stops, and the file is written, also when the block raises."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities,
                                  on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    prof.start()
    try:
        yield
    finally:
        prof.stop()


class StepTimer:
    """Images/sec meter excluding the first (build and warm-up) steps.

    The clock starts at the ``warmup_steps``-th ``step()`` and the images of
    later steps count. It reads the host clock: a caller timing CUDA work
    calls ``torch.cuda.synchronize()`` before each ``step()``, since kernels
    run after their launch returns.
    """

    def __init__(self, warmup_steps: int = 2) -> None:
        self.warmup_steps = warmup_steps
        self.reset()

    def reset(self) -> None:
        self._steps = 0
        self._images = 0
        self._t0: Optional[float] = None

    def step(self, batch_images: int) -> None:
        self._steps += 1
        if self._steps == self.warmup_steps:
            self._t0 = time.perf_counter()
            return
        if self._steps > self.warmup_steps:
            self._images += batch_images

    @property
    def images_per_sec(self) -> float:
        if self._t0 is None or self._images == 0:
            return 0.0
        return self._images / max(time.perf_counter() - self._t0, 1e-9)
