"""Host ms a train step in the program's ``step.backward`` span (``torch.autograd.grad``):
the median over pass (a)'s steps (``perfbench/spans.py``: recording on, in a process
that has made no capture)."""

from perfbench.spans import host_ms


def read(r):
    return host_ms(r, "step.backward")
