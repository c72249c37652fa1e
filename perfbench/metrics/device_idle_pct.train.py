"""The device's idle share of the window's train steps: 1 − the traced
steps' busy time a step (the union of kernel intervals) over the window's
seconds a step."""

from perfbench.readers import idle_pct as read  # noqa: F401
