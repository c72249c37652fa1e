"""Host ms a served batch in ``Predictor``'s ``serve.stage`` span (pad, pinned copy, H2D
enqueue): the median over pass (a)'s batches (``perfbench/spans.py``: recording on, in a
process that has made no capture)."""

from perfbench.spans import host_ms


def read(r):
    return host_ms(r, "serve.stage")
