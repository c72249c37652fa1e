"""Batched inference for Theia models on one GPU or several (port of theia_tpu/serving.py:43-191).

``Predictor`` gives the serving loop the shape the JAX one has:
  - **bucketed static batches**: inputs are zero-padded up to one of a fixed
    set of batch sizes (oversized batches are chunked by the largest), so the
    device always sees the same few shapes;
  - **asynchronous H2D**: each batch is copied into pinned host memory and
    sent with ``non_blocking=True`` on a side stream; the compute stream
    waits on a CUDA event, so the copy of batch k+1 overlaps batch k's
    compute;
  - **pipelined streaming**: ``predict_stream`` keeps ``depth`` batches in
    flight before the first readback;
  - **narrow readback**: ``out_dtype`` casts on the device before the D2H
    copy; results are upcast to float32 on the host;
  - **replicas** (the JAX ``mesh=`` path, serving.py:86-103,144-145):
    ``devices=[...]`` keeps one copy of the model on each device, rounds
    every bucket up to a multiple of the replica count, splits each padded
    batch in order over the replicas, each on a stream of its own, and
    concatenates their outputs in order;
  - **spans** (``utils/profiling.py``, inside a ``recording()`` block): an
    input batch records ``serve.batch`` around ``serve.stage`` (pad, pinned
    copy, H2D enqueue), ``serve.dispatch`` (the forward's launches) and,
    where a batch is read back while it is taken, ``serve.readback`` (the
    D2H copy and its wait for the device), whose unit is the number of the
    batch read back; a stream's last readbacks, after its input ends, are
    spans of their own.

Inputs are numpy uint8 images [B,H,W,C] or [B,C,H,W]; outputs are numpy
float32 arrays ([B,T,C] tokens, or a dict of [B,HW,C] per teacher). On a CPU
model the same code runs without streams.
"""

from __future__ import annotations

import contextlib
import copy
from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn

from theia_tpu_torch.utils.profiling import span


def _map(fn: Callable[[torch.Tensor], Any], out: Any) -> Any:
    """Apply ``fn`` to a tensor or to each value of a dict of tensors."""
    if isinstance(out, dict):
        return {k: fn(v) for k, v in out.items()}
    return fn(out)


class Predictor:
    """Bucketed, pipelined inference over a ``Theia`` module.

    Args:
        model: a ``Theia`` (or any module with ``forward_feature``) already
            on its device and dtype.
        buckets: allowed static batch sizes.
        method: "forward_feature" (spatial tokens) or "predict" (dict of
            per-teacher features, the module's forward).
        depth: how many batches ``predict_stream`` keeps in flight before
            reading one back.
        out_dtype: optional on-device cast before readback (e.g.
            ``torch.bfloat16`` halves the D2H bytes); the host then sees
            float32 with bf16's ~3 significant digits.
        devices: optional list of devices, one replica each (``model``
            itself serves the first of them if it lies there; the others
            get copies). Each bucket is rounded up to a multiple of
            ``len(devices)``; a padded batch of b rows gives each replica
            b / len(devices) of them, in order. None: ``model`` alone, on
            the current stream of its device.
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        buckets: Sequence[int] = (1, 4, 16, 64),
        method: str = "forward_feature",
        depth: int = 2,
        out_dtype: Optional[torch.dtype] = None,
        devices: Optional[Sequence[torch.device | str]] = None,
    ) -> None:
        if method not in ("forward_feature", "predict"):
            raise ValueError(f"unknown method {method!r}")
        home = next(model.parameters()).device
        if devices is None:
            models, own_streams = [model], False
        else:
            devices = [torch.device(d) for d in devices]
            if not devices:
                raise ValueError("devices must name at least one device")
            models = [model if i == 0 and d == home else copy.deepcopy(model).to(d) for i, d in enumerate(devices)]
            own_streams = True
        fns = [m.forward_feature if method == "forward_feature" else m for m in models]
        self._fn = fns[0]  # the first replica's; the others' follow in _replica_fns
        self._replica_fns = fns[1:]
        self._devices = [next(m.parameters()).device for m in models]
        self._device = self._devices[0]
        n = len(models)
        # every bucket splits evenly over the replicas
        self._buckets = tuple(sorted({-(-int(b) // n) * n for b in buckets}))
        self._depth = max(1, int(depth))
        self._out_dtype = out_dtype
        self._copy_streams = [torch.cuda.Stream(d) if d.type == "cuda" else None for d in self._devices]
        self._batches = 0  # input batches taken, the unit of their spans
        self._compute_streams = [torch.cuda.Stream(d) if d.type == "cuda" and own_streams else None
                                 for d in self._devices]

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _stream(self, i: int) -> contextlib.AbstractContextManager:
        """Replica i's own stream and device, where it has a stream of its own."""
        s = self._compute_streams[i]
        if s is None:
            return contextlib.nullcontext()
        stack = contextlib.ExitStack()
        stack.enter_context(torch.cuda.device(s.device))
        stack.enter_context(torch.cuda.stream(s))
        return stack

    def _stage(self, images: np.ndarray) -> tuple[list[tuple[torch.Tensor, Optional[torch.cuda.Event]]], int]:
        """Pad to a bucket, split over the replicas and start each part's H2D
        copy; returns ([(device tensor, ready event) a replica], n)."""
        n = images.shape[0]
        b = self._bucket(n)
        per = b // len(self._devices)
        host = torch.from_numpy(np.ascontiguousarray(images))
        if all(s is None for s in self._copy_streams):
            if n < b:
                host = torch.cat([host, host.new_zeros((b - n, *host.shape[1:]))])
            return [(host[i * per:(i + 1) * per].to(d), None) for i, d in enumerate(self._devices)], n
        pinned = torch.empty((b, *host.shape[1:]), dtype=host.dtype, pin_memory=True)
        pinned[:n].copy_(host)
        pinned[n:].zero_()
        parts = []
        for i, (d, s) in enumerate(zip(self._devices, self._copy_streams)):
            with torch.cuda.stream(s):
                dev = pinned[i * per:(i + 1) * per].to(d, non_blocking=True)
                ready = torch.cuda.Event()
                ready.record(s)
            parts.append((dev, ready))
        return parts, n

    def _dispatch(self, staged: tuple[list, int]) -> tuple[list[Any], int]:
        parts, n = staged
        outs = []
        for i, (fn, (dev, ready)) in enumerate(zip([self._fn, *self._replica_fns], parts)):
            with self._stream(i):
                if ready is not None:
                    compute = torch.cuda.current_stream(dev.device)
                    compute.wait_event(ready)
                    dev.record_stream(compute)  # allocated on the copy stream, read on this one
                with torch.inference_mode():
                    out = fn(dev)
                    if self._out_dtype is not None:
                        out = _map(lambda y: y.to(self._out_dtype), out)
            outs.append(out)
        return outs, n

    def _readback(self, result: list[Any], n: int) -> Any:
        def host(y: torch.Tensor, rows: int) -> np.ndarray:
            y = y[:rows].cpu()  # the D2H copy moves the device dtype, after the replica's stream
            if self._out_dtype is not None or y.dtype == torch.bfloat16:
                y = y.float()
            return y.numpy()

        parts, left = [], n
        for i, out in enumerate(result):
            if left <= 0:
                break
            per = next(iter(out.values())).shape[0] if isinstance(out, dict) else out.shape[0]
            rows = min(per, left)
            with self._stream(i):
                parts.append(_map(lambda y: host(y, rows), out))
            left -= rows
        return _concat(parts)

    def _chunks(self, images: np.ndarray) -> list[np.ndarray]:
        top = self._buckets[-1]
        return [images[i : i + top] for i in range(0, images.shape[0], top)] or [images]

    def _take(self, images: np.ndarray) -> tuple[int, list]:
        """One input batch staged and dispatched: (its number, its dispatched chunks)."""
        unit, self._batches = self._batches, self._batches + 1
        with span("serve.stage", unit):
            staged = [self._stage(c) for c in self._chunks(np.asarray(images))]
        with span("serve.dispatch", unit):
            return unit, [self._dispatch(s) for s in staged]

    def __call__(self, images: np.ndarray) -> Any:
        """Predict one batch (any size; chunked by the largest bucket)."""
        with span("serve.batch", self._batches):
            return self._readback_group(self._take(images))

    def predict_stream(self, batches: Iterable[np.ndarray]) -> Iterator[Any]:
        """Pipelined prediction over a stream of batches, order-preserving."""
        pending: deque = deque()
        for images in batches:
            with span("serve.batch", self._batches):
                pending.append(self._take(images))
                out = self._readback_group(pending.popleft()) if len(pending) > self._depth else None
            if out is not None:
                yield out
        while pending:
            yield self._readback_group(pending.popleft())

    def _readback_group(self, taken: tuple[int, list]) -> Any:
        unit, group = taken
        with span("serve.readback", unit):
            return _concat([self._readback(r, n) for r, n in group])


def _concat(outs: list[Any]) -> Any:
    """Host outputs (arrays, or dicts of them) joined along the batch, in order."""
    if len(outs) == 1:
        return outs[0]
    if isinstance(outs[0], dict):
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
    return np.concatenate(outs)
