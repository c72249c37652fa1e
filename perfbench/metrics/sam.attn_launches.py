"""Kernels an extraction batch launched inside the encoder's attention calls,
the spans ``sam.attn.window`` and ``sam.attn.global`` (a kernel counts where
its launch record lies; the span passes' capture, ``perfbench/spans.py``)."""

from perfbench.spans import launches


def read(r):
    parts = [launches(r, name) for name in ("sam.attn.window", "sam.attn.global")]
    return None if all(p is None for p in parts) else sum(p or 0.0 for p in parts)
