"""Device idle ms a served batch while the host was in ``serve.readback``: the time of
pass (b)'s capture in which no kernel ran, split over the innermost span the
host was in, summed, over the batches. "Idle" means no kernel running: the
capture keeps kernels alone, so the batch's float32 copy to the host, which
runs on the compute stream inside this span, counts as idle here."""

from perfbench.spans import idle_ms


def read(r):
    return idle_ms(r, "serve.readback")
