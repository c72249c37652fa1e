"""Batched inference for Theia models on one GPU (port of theia_tpu/serving.py:43-191).

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
    copy; results are upcast to float32 on the host.

Inputs are numpy uint8 images [B,H,W,C] or [B,C,H,W]; outputs are numpy
float32 arrays ([B,T,C] tokens, or a dict of [B,HW,C] per teacher). On a CPU
model the same code runs without streams. Multi-GPU serving (the JAX
``mesh=`` path) is not ported yet (ROADMAP).
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch
from torch import nn


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
    """

    def __init__(
        self,
        model: nn.Module,
        *,
        buckets: Sequence[int] = (1, 4, 16, 64),
        method: str = "forward_feature",
        depth: int = 2,
        out_dtype: Optional[torch.dtype] = None,
    ) -> None:
        if method == "forward_feature":
            self._fn = model.forward_feature
        elif method == "predict":
            self._fn = model
        else:
            raise ValueError(f"unknown method {method!r}")
        self._device = next(model.parameters()).device
        self._buckets = tuple(sorted({int(b) for b in buckets}))
        self._depth = max(1, int(depth))
        self._out_dtype = out_dtype
        self._copy_stream = torch.cuda.Stream(self._device) if self._device.type == "cuda" else None

    def _bucket(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        return self._buckets[-1]

    def _stage(self, images: np.ndarray) -> tuple[torch.Tensor, int, Optional[torch.cuda.Event]]:
        """Pad to a bucket and start the H2D copy; returns (device tensor, n, ready event)."""
        n = images.shape[0]
        b = self._bucket(n)
        host = torch.from_numpy(np.ascontiguousarray(images))
        if self._copy_stream is None:
            if n < b:
                host = torch.cat([host, host.new_zeros((b - n, *host.shape[1:]))])
            return host.to(self._device), n, None
        pinned = torch.empty((b, *host.shape[1:]), dtype=host.dtype, pin_memory=True)
        pinned[:n].copy_(host)
        pinned[n:].zero_()
        with torch.cuda.stream(self._copy_stream):
            dev = pinned.to(self._device, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record(self._copy_stream)
        return dev, n, ready

    def _dispatch(self, staged: tuple[torch.Tensor, int, Optional[torch.cuda.Event]]) -> tuple[Any, int]:
        dev, n, ready = staged
        if ready is not None:
            compute = torch.cuda.current_stream(self._device)
            compute.wait_event(ready)
            dev.record_stream(compute)  # allocated on the copy stream, read on this one
        with torch.inference_mode():
            out = self._fn(dev)
            if self._out_dtype is not None:
                out = _map(lambda y: y.to(self._out_dtype), out)
        return out, n

    def _readback(self, result: Any, n: int) -> Any:
        def host(y: torch.Tensor) -> np.ndarray:
            y = y[:n].cpu()  # the D2H copy moves the device dtype
            if self._out_dtype is not None or y.dtype == torch.bfloat16:
                y = y.float()
            return y.numpy()

        return _map(host, result)

    def _chunks(self, images: np.ndarray) -> list[np.ndarray]:
        top = self._buckets[-1]
        return [images[i : i + top] for i in range(0, images.shape[0], top)] or [images]

    def __call__(self, images: np.ndarray) -> Any:
        """Predict one batch (any size; chunked by the largest bucket)."""
        staged = [self._stage(c) for c in self._chunks(np.asarray(images))]
        return self._readback_group([self._dispatch(s) for s in staged])

    def predict_stream(self, batches: Iterable[np.ndarray]) -> Iterator[Any]:
        """Pipelined prediction over a stream of batches, order-preserving."""
        pending: deque = deque()
        for images in batches:
            staged = [self._stage(c) for c in self._chunks(np.asarray(images))]
            pending.append([self._dispatch(s) for s in staged])
            if len(pending) > self._depth:
                yield self._readback_group(pending.popleft())
        while pending:
            yield self._readback_group(pending.popleft())

    def _readback_group(self, group: list) -> Any:
        outs = [self._readback(r, n) for r, n in group]
        if len(outs) == 1:
            return outs[0]
        if isinstance(outs[0], dict):
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        return np.concatenate(outs)
