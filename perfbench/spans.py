"""The program's own spans (``theia_tpu_torch/utils/profiling.py``), read for the per-layer metrics of a traced run.

The train step records ``step`` around ``step.forward``, ``step.loss``,
``step.backward``, ``step.reduce`` (ranks > 1 or a cut model), ``step.clip``
(``grad_clip``) and ``step.optimizer``; ``serving.Predictor`` records
``serve.batch`` around ``serve.stage``, ``serve.dispatch`` and
``serve.readback``. Their times are on torch.profiler's clock (Unix-epoch
ns), so they lie over a capture's kernels and launch records.

The first span metric a ``--trace 1`` run reads (``passes(r)``, after the
run's window, captures and check) starts this module as a process of its
own, ``python3 -m perfbench.spans``, and hands it the run's configuration,
traffic, cell, ``--seed``, traced units and device as one JSON object on
standard input. No capture has run in that process, so no CUPTI cost a launch lies
on its host clock. It sets the cell up and runs ``units`` more steps or
batches five times:

  recording off, on, on, off, each ended by a synchronize: the ms a unit
      off and on (what recording costs), and, from the two runs on, pass
      (a): each span's host ms, the median over units;
  (b) recording on under a capture of the device alone (``trace.capture``):
      its kernels, their launch records and the spans of the same calls.

On (b), ``idle_by_span`` splits the device's idle time (no kernel running;
a copy to or from the host counts as idle, since the capture keeps kernels
alone) over the innermost program span the host was in, and
``launched_in`` counts the kernels whose launch record lies inside a span.
The process prints one line on standard error for every span name it saw
(host ms, idle ms and kernels launched a unit) and the cost line, and its
readings as the last line of standard output, which ``passes`` reads. A
program without ``profiling.recording`` (an earlier tree), or a run without
``--seed``, starts nothing: every span metric then reads None.
"""

from __future__ import annotations

import argparse
import bisect
import gc
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Optional

from perfbench import trace
from perfbench.trace import Trace

ROOT = Path(__file__).resolve().parent.parent


def _depth(span) -> int:
    return 0 if span.parent is None else 1 + _depth(span.parent)


def _innermost_pieces(spans: list) -> tuple[list[float], list[Optional[str]]]:
    """The host's timeline cut where a span starts or ends: the cut points
    in us and, for each piece between two of them, the name of the
    innermost (deepest) span open through it, or None."""
    cuts = sorted({t / 1e3 for s in spans for t in (s.start_ns, s.end_ns)})
    names = []
    for lo, hi in zip(cuts, cuts[1:]):
        open_ = [s for s in spans if s.start_ns / 1e3 <= lo and hi <= s.end_ns / 1e3]
        names.append(max(open_, key=_depth).name if open_ else None)
    return cuts, names


def idle_by_span(tr: Trace, spans: list) -> dict[Optional[str], float]:
    """Idle us of the device between its first kernel's start and its last
    kernel's end, by the innermost program span the host was in while the
    device idled (None: in no span). Each piece of the host's timeline
    takes its length less the kernels' busy time inside it
    (``trace.busy_ms``), so the values add up to the capture's idle time."""
    ks = sorted((k.start_us, k.start_us + k.dur_us) for k in tr.kernels)
    if not ks:
        return {}
    first, last = ks[0][0], max(end for _, end in ks)
    starts = [s for s, _ in ks]
    longest = max(end - s for s, end in ks)
    cuts, names = _innermost_pieces(spans)
    edges = [first, *(c for c in cuts if first < c < last), last]
    out: dict[Optional[str], float] = defaultdict(float)
    for lo, hi in zip(edges, edges[1:]):
        i = bisect.bisect_right(cuts, lo) - 1  # the piece [cuts[i], cuts[i + 1]) that holds lo
        near = ks[bisect.bisect_left(starts, lo - longest):bisect.bisect_left(starts, hi)]
        busy = 1e3 * trace.busy_ms([(max(s, lo), min(end, hi)) for s, end in near if end > lo])
        out[names[i] if 0 <= i < len(names) else None] += hi - lo - busy
    return dict(out)


def launched_in(tr: Trace, spans: list) -> int:
    """Kernels whose launch record lies inside one of ``spans``."""
    inside = [(s.start_ns / 1e3, s.end_ns / 1e3) for s in spans]
    count = 0
    for k in tr.kernels:
        launch = tr.launches.get(k.correlation)
        if launch is not None and any(lo <= launch[0] <= hi for lo, hi in inside):
            count += 1
    return count


def ms_per_unit(spans: list, name: str) -> Optional[float]:
    """The median over units of the host ms a unit spent in spans named ``name``."""
    by = defaultdict(float)
    for s in spans:
        if s.name == name:
            by[s.unit] += s.ms
    return statistics.median(by.values()) if by else None


def summarise(units: int, host: list, tr: Trace, traced: list) -> dict:
    """The readings of the two passes, by span name: pass (a)'s host ms a
    unit (``host``), pass (b)'s idle ms a unit (where it holds kernels) and
    kernels launched a unit (where it holds launch records)."""
    names = list(dict.fromkeys(s.name for s in [*host, *traced]))
    idle = idle_by_span(tr, traced)
    seen = {s.name for s in traced}
    return {
        "units": units,
        "names": names,
        "host_ms": {n: ms_per_unit(host, n) for n in names if any(s.name == n for s in host)},
        "idle_ms": {n: idle.get(n, 0.0) / 1e3 / units for n in names if n in seen and tr.kernels},
        "launches": {n: launched_in(tr, [s for s in traced if s.name == n]) / units
                     for n in names if n in seen and tr.launches},
    }


# ------------------------------------------------------------ the passes

def _seed() -> Optional[int]:
    """The run's ``--seed``, parsed as ``perfbench/run.py`` parses its
    arguments (None where the process was started without one)."""
    parser = argparse.ArgumentParser(add_help=False)
    for flag in ("--workload", "--seed", "--seconds", "--trace"):
        parser.add_argument(flag)
    seed = parser.parse_known_args(sys.argv[1:])[0].seed
    return None if seed is None else int(seed)


def passes(r) -> Optional[dict]:
    """The readings of passes (a) and (b) for the run whose readings ``r``
    are, made once a run (``r.span_passes`` keeps them for the other span
    metrics); None without a trace, a card, the program's recorder or a
    seed."""
    if not hasattr(r, "span_passes"):
        r.span_passes = _start(r)
    return r.span_passes


def _start(r) -> Optional[dict]:
    import torch

    if r.trace is None or not torch.cuda.is_available():
        return None
    try:
        from theia_tpu_torch.utils.profiling import recording  # noqa: F401
    except ImportError:
        return None
    seed = _seed()
    if seed is None:
        return None
    gc.collect()
    torch.cuda.empty_cache()  # the run's and its check's blocks, for the process below
    job = {"cfg": r.cfg, "traffic": r.traffic, "cell": r.cell, "seed": seed, "units": r.units, "device": "cuda:0"}
    done = subprocess.run([sys.executable, "-m", "perfbench.spans"], input=json.dumps(job), cwd=ROOT,
                          stdout=subprocess.PIPE, text=True)
    lines = done.stdout.strip().splitlines()
    if done.returncode != 0 or not lines:
        print(f"spans: the passes' process exited {done.returncode}", file=sys.stderr)
        return None
    return json.loads(lines[-1])


def main() -> int:
    """The passes' process: a job on standard input, readings out."""
    import torch

    from perfbench import spec
    from theia_tpu_torch.utils.profiling import recording

    job = json.load(sys.stdin)
    units = int(job["units"])
    torch.set_num_threads(int(job["traffic"]["host_threads"]))
    drv = spec.driver_class(job["traffic"]["driver"])(job["cfg"], job["traffic"], job["cell"], int(job["seed"]),
                                                      torch.device(job["device"]))
    drv.setup()
    ms, host = {False: [], True: []}, []
    for on in (False, True, True, False):
        t0 = time.perf_counter()
        if on:
            with recording() as rec:
                drv.run_units(units)
            host += rec.drain()
        else:
            drv.run_units(units)
        ms[on].append(1e3 * (time.perf_counter() - t0) / units)
    with recording() as rec:
        tr = trace.capture(lambda: drv.run_units(units))
    out = summarise(units, host, tr, rec.drain())
    drv.free()
    unit = {"batches": "batch"}.get(drv.unit, drv.unit.rstrip("s"))
    for n in out["names"]:
        print(f"spans: {n}: {out['host_ms'].get(n)!r} host ms a {unit} (pass a); "
              f"{out['idle_ms'].get(n)!r} ms of the card's idle while innermost, "
              f"{out['launches'].get(n)!r} kernels launched, a {unit} (pass b)", file=sys.stderr)
    print(f"spans: {units} {drv.unit} a run, recording off {ms[False]!r} ms a {unit}, on {ms[True]!r}; pass (b) "
          f"{tr.window_us() / 1e3 / units!r} ms a {unit} from first kernel to last, {len(tr.kernels)} kernels, "
          f"{len(tr.launches)} launch records", file=sys.stderr)
    out["off_ms"], out["on_ms"] = ms[False], ms[True]
    sys.stdout.write(json.dumps(out) + "\n")
    return 0


# ------------------------------------------------------------ what the metrics read

def host_ms(r, name: str) -> Optional[float]:
    """Pass (a): the median host ms a unit in ``name``."""
    p = passes(r)
    return None if p is None else p["host_ms"].get(name)


def idle_ms(r, name: str) -> Optional[float]:
    """Pass (b): device idle ms a unit while the host was in ``name`` (and in no span inside it)."""
    p = passes(r)
    return None if p is None else p["idle_ms"].get(name)


def launches(r, name: str) -> Optional[float]:
    """Pass (b): kernels a unit launched inside ``name``."""
    p = passes(r)
    return None if p is None else p["launches"].get(name)


if __name__ == "__main__":
    sys.exit(main())
