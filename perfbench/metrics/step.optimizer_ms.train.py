"""Host ms a train step in the program's ``step.optimizer`` span (the update mask and
``tx.update``, a wait on a full launch queue included): the median over pass
(a)'s steps (``perfbench/spans.py``: recording on, in a process that has made no
capture). The in-program twin of ``optimizer_ms.train``, which times the same
phase by the host clock around ``tx.update`` in the window."""

from perfbench.spans import host_ms


def read(r):
    return host_ms(r, "step.optimizer")
