"""Profiling hooks: a torch.profiler trace, a step timer and program spans (port of theia_tpu/utils/profiling.py).

- ``trace(logdir)``: a context manager around ``torch.profiler.profile``
  that records the host's activity, and the card's where CUDA is available,
  and writes one Chrome/Perfetto trace file (``*.pt.trace.json``) into
  ``logdir``, viewable in Perfetto or TensorBoard's profiler;
- ``StepTimer``: a step and images-per-second meter that leaves out the
  first (build and warm-up) steps;
- ``span(name, unit)`` and ``recording()``: named host intervals around the
  phases of the train step and of ``serving.Predictor`` (the JAX package has
  none). Off by default: ``span`` then hands back one shared no-op context
  and costs one check of a module variable. Inside ``with recording() as
  rec:`` each span records its name, start, end, enclosing span and unit (a
  train step's or a served batch's host-side count) in memory, never
  synchronizing; ``rec.drain()`` hands them over. Times are Unix-epoch
  nanoseconds from ``time.time_ns()``, the clock that torch.profiler's
  events carry (``start_ns()``), so a span can be laid over a profiler
  capture of the same process and a device kernel put down to the span
  that was open when it was launched.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
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


@dataclass(eq=False)
class Span:
    """One recorded interval, in Unix-epoch ns on torch.profiler's clock."""

    name: str
    unit: Optional[int]  # the train step's or the served batch's host-side count
    parent: Optional["Span"] = None  # the span open around this one on its thread, when it started
    start_ns: int = 0
    end_ns: int = 0

    @property
    def ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class Recorder:
    """The spans of one ``recording()`` block, finished ones in the order they ended."""

    def __init__(self) -> None:
        self._done: list[Span] = []
        self._local = threading.local()

    def _stack(self) -> list[Span]:
        return self._local.__dict__.setdefault("stack", [])

    def spans(self) -> list[Span]:
        return list(self._done)

    def drain(self) -> list[Span]:
        """The finished spans, which the recorder then forgets."""
        out, self._done = self._done, []
        return out


class _Open:
    """A span being recorded: the clock read last on entry and first on exit."""

    __slots__ = ("rec", "span")

    def __init__(self, rec: Recorder, name: str, unit: Optional[int]) -> None:
        self.rec, self.span = rec, Span(name, unit)

    def __enter__(self) -> None:
        stack = self.rec._stack()
        self.span.parent = stack[-1] if stack else None
        stack.append(self.span)
        self.span.start_ns = time.time_ns()

    def __exit__(self, *exc) -> None:
        self.span.end_ns = time.time_ns()
        self.rec._stack().pop()
        self.rec._done.append(self.span)


_RECORDER: Optional[Recorder] = None
_OFF = contextlib.nullcontext()


def span(name: str, unit: Optional[int] = None) -> contextlib.AbstractContextManager:
    """A context that records ``name`` while a ``recording()`` block is open,
    else one shared no-op context (no clock read, nothing allocated)."""
    if _RECORDER is None:
        return _OFF
    return _Open(_RECORDER, name, unit)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record the spans of the block (the block's only: an enclosing
    ``recording()`` gets none of them)."""
    global _RECORDER
    outer, _RECORDER = _RECORDER, Recorder()
    try:
        yield _RECORDER
    finally:
        _RECORDER = outer
