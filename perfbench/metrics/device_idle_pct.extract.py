"""The device's idle share of the window's extraction batches: 1 − the traced
batches' busy time a batch (the union of kernel intervals) over the window's
seconds a completed batch."""

from perfbench.readers import idle_pct as read  # noqa: F401
