"""Device idle ms an extraction batch while the host was in ``extract.stage``
(the uint8 batch's copy to the card) or ``extract.readback`` (both stores'
copies to the host): the time of the span passes' capture in which no
kernel ran, split over the innermost span the host was in, summed over the
two, over the batches (``perfbench/spans.py``). A copy is no kernel, so the
copies themselves count as idle here."""

from perfbench.spans import idle_ms


def read(r):
    parts = [idle_ms(r, name) for name in ("extract.stage", "extract.readback")]
    return None if all(p is None for p in parts) else sum(p or 0.0 for p in parts)
