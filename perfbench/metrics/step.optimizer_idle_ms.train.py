"""Device idle ms a train step while the host was in ``step.optimizer``: the time of
pass (b)'s capture in which no kernel ran, split over the innermost span the
host was in, summed, over the steps (a copy or a fill counts as idle: the
capture keeps kernels alone)."""

from perfbench.spans import idle_ms


def read(r):
    return idle_ms(r, "step.optimizer")
