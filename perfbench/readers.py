"""What the per-layer metrics read, and the arithmetic they share.

A metric file (``perfbench/metrics/<name>.py``) defines ``read(r)`` over a
``Readings`` and returns a number, or None where its run has nothing for it
to read (no kernel of its name in the trace, no trace at all): the harness
then leaves the metric out of the line. A share of a roofline or of a peak
is never made 0 for want of a reading.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Optional

from perfbench import flops
from perfbench.trace import Trace


@dataclass
class Readings:
    cfg: dict
    traffic: dict
    cell: dict
    batch: int
    units: int  # steps or batches in the trace
    trace: Optional[Trace]
    window: dict  # the measured window: rates, latencies, seconds


def idle_pct(r: Readings) -> Optional[float]:
    """The device's idle share of the window: 1 − the traced busy time a
    unit (the union of kernel intervals) over the window's seconds a unit.
    The traced span itself is not the denominator: even a capture of the
    device alone costs the host time a launch, which a host-paced step
    would read as idle. Where the card paces, this may read a little under
    0, busy time and step time coming from different steps."""
    if r.trace is None or not r.trace.kernels or not r.window.get("done"):
        return None
    busy_s = r.trace.busy_us() / 1e6 / r.units
    return 100.0 * (1.0 - busy_s / (r.window["seconds"] / r.window["done"]))


def class_ms_per_unit(r: Readings, label: str) -> Optional[float]:
    if r.trace is None or not r.trace.kernels:
        return None
    us = r.trace.class_us(label)
    return us / 1e3 / r.units if us else None


def roofline_pct(r: Readings, calls: list[flops.Call], keys: tuple[str, ...]) -> Optional[float]:
    """Σ bound of a unit's calls times the traced units, over Σ time of
    the kernels whose names hold one of ``keys``, in %. The calls come from
    the shapes the configuration gives; where the trace holds another number
    of such kernels (the program calls them otherwise, or a record was
    dropped), nothing is read."""
    if r.trace is None:
        return None
    kernels = r.trace.matching(*keys)
    if not kernels:
        return None
    expected = r.units * sum(c.launches for c in calls)
    if len(kernels) != expected:
        print(f"perfbench: {len(kernels)} kernels named {' or '.join(keys)} in the trace, {expected} from the "
              "shapes: no roofline read", file=sys.stderr)
        return None
    bound_s = r.units * sum(c.bound_s() for c in calls)
    return 100.0 * bound_s / (sum(k.dur_us for k in kernels) / 1e6)


def mfu_pct(flops_per_image: float, images_per_s: Optional[float], peak: str) -> Optional[float]:
    if not images_per_s:
        return None
    return 100.0 * flops_per_image * images_per_s / flops.PEAK_FLOPS[peak]
