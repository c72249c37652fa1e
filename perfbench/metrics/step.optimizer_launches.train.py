"""Kernels a train step launched inside ``step.optimizer``: kernels of pass (b)'s
capture (``perfbench/spans.py``) whose launch record lies in the span, over the steps."""

from perfbench.spans import launches


def read(r):
    return launches(r, "step.optimizer")
