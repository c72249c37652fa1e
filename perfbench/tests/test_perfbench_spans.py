"""``perfbench/spans.py`` on synthetic traces and spans: an idle gap is split
over the spans the host was in through it, a step's children's shares add
up to the step's idle, a kernel counts in the span its launch lies in; the
nine span metrics read these, or None where a run has no spans (no trace,
no seed, or a program without the recorder); the run's seed is parsed as
``perfbench/run.py`` parses it; and the passes' process runs a tiny cell on
the CPU."""

from __future__ import annotations

import io
import json

import pytest
import torch

from perfbench import spans, spec, trace
from perfbench.readers import Readings
from perfbench.tests import tiny
from perfbench.trace import Kernel, Trace
from theia_tpu_torch.utils import profiling
from theia_tpu_torch.utils.profiling import Span

BENCH = spec.benchmark()
SPAN_METRICS = {m["name"]: m for m in BENCH["per_layer"] if m["source"] == "program_span"}


def _span(name, unit, lo_us, hi_us, parent=None):
    return Span(name, unit, parent, int(lo_us * 1e3), int(hi_us * 1e3))


def _trace(kernels, launches=None):
    """Kernels as (start, end) us, correlation = index; launches: index -> us."""
    return Trace(kernels=[Kernel(f"k{i}", s, e - s, i) for i, (s, e) in enumerate(kernels)],
                 launches={i: (t, 1) for i, t in (launches or {}).items()})


def _step(unit, t0):
    """A step at ``t0`` us: forward 0–20, loss 20–25, backward 25–60, optimizer 65–100 (self 60–65)."""
    top = _span("step", unit, t0, t0 + 100)
    return [top] + [_span(n, unit, t0 + lo, t0 + hi, top) for n, lo, hi in
                    (("step.forward", 0, 20), ("step.loss", 20, 25), ("step.backward", 25, 60),
                     ("step.optimizer", 65, 100))]


def test_a_gap_is_split_over_the_spans_the_host_was_in():
    tr = _trace([(0, 10), (30, 40), (75, 80), (120, 130)])
    got = spans.idle_by_span(tr, _step(0, 0))
    # 10–30: forward to 20, loss to 25, backward; 40–75: backward to 60, step to 65, optimizer;
    # 80–120: optimizer to 100, then no span
    assert got == pytest.approx({"step.forward": 10, "step.loss": 5, "step.backward": 25, "step": 5,
                                 "step.optimizer": 30, None: 20})


def test_a_steps_children_add_up_to_its_idle():
    generator = torch.Generator().manual_seed(0)
    starts = torch.sort(torch.rand(60, generator=generator) * 290).values.tolist()
    kernels = [(s, s + d) for s, d in zip(starts, (torch.rand(60, generator=generator) * 4).tolist())]
    tr = _trace(kernels)
    recorded = _step(0, 0) + _step(1, 150)
    got = spans.idle_by_span(tr, recorded)
    assert sum(got.values()) == pytest.approx(tr.window_us() - tr.busy_us())
    # the step's idle inside its two intervals (within the device's first to last kernel) is its own share
    # and its children's
    first, last = min(s for s, _ in kernels), max(e for _, e in kernels)
    inside = 0.0
    for t0 in (0, 150):
        lo, hi = max(t0, first), min(t0 + 100, last)
        inside += hi - lo - 1e3 * trace.busy_ms([(max(s, lo), min(e, hi)) for s, e in kernels if s < hi and e > lo])
    assert sum(v for k, v in got.items() if k and k.startswith("step")) == pytest.approx(inside)


def test_a_kernel_counts_in_the_span_its_launch_lies_in():
    recorded = _step(0, 0)
    tr = _trace([(5, 6), (30, 31), (70, 71), (90, 91), (95, 96), (130, 131)],
                launches={0: 1.0, 1: 21.0, 2: 66.0, 3: 80.0, 5: 101.0})  # kernel 4's record dropped
    optimizer = [s for s in recorded if s.name == "step.optimizer"]
    assert spans.launched_in(tr, optimizer) == 2
    assert spans.launched_in(tr, [s for s in recorded if s.parent is None]) == 4


def test_ms_per_unit_is_the_median_over_units():
    recorded = [_span("serve.readback", u, 0, ms * 1e3) for u, ms in enumerate((3.0, 1.0, 2.0, 10.0, 4.0))]
    assert spans.ms_per_unit(recorded, "serve.readback") == pytest.approx(3.0)
    assert spans.ms_per_unit(recorded, "serve.stage") is None


def _readings(trace, driver="train"):
    return Readings({}, {"driver": driver}, {}, 4, 2, trace, {})


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_read_none_without_spans(name, monkeypatch):
    read = spec.metric_reader(name).read
    assert read(_readings(None)) is None  # an untraced run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(spans.subprocess, "run", lambda *a, **k: pytest.fail("the passes' process was started"))
    monkeypatch.setattr(spans.sys, "argv", ["perfbench/run.py", "--workload", "x", "--trace", "1"])
    assert read(_readings(_trace([(0, 1)]))) is None  # a run without a seed
    # a program without the recorder (an earlier tree): nothing is started, nothing read
    monkeypatch.setattr(spans.sys, "argv", ["perfbench/run.py", "--seed", "3", "--trace", "1"])
    monkeypatch.delattr(profiling, "recording")
    assert read(_readings(_trace([(0, 1)]))) is None


@pytest.mark.parametrize("argv, seed", [
    (["--workload", "w", "--seed", "2147500011", "--seconds", "51", "--trace", "1"], 2147500011),
    (["--workload=w", "--see", "7", "--sec", "51"], 7),  # run.py's parser takes abbreviations
    (["--seed=-5", "--trace", "1"], -5),
    (["--workload", "w", "--seconds", "51"], None),
])
def test_the_seed_is_parsed_as_run_parses_it(argv, seed, monkeypatch):
    monkeypatch.setattr(spans.sys, "argv", ["perfbench/run.py", *argv])
    assert spans._seed() == seed


READ = {  # two steps of _step, or two served batches; the expected reading
    "step.forward_ms.train": 0.02,
    "step.backward_ms.train": 0.035,
    "step.optimizer_ms.train": 0.035,
    "step.optimizer_idle_ms.train": 0.015,  # 10 + 20 us in the first step, none in the second
    "step.optimizer_launches.train": 1.5,
    "serve.stage_ms": 0.01,
    "serve.dispatch_ms": 0.02,
    "serve.readback_ms": 0.04,
    "serve.readback_idle_ms": 0.01,
}


def _batch(unit, t0, readback):
    top = _span("serve.batch", unit, t0, t0 + 100)
    return [top, _span("serve.stage", unit, t0, t0 + 10, top), _span("serve.dispatch", unit, t0 + 10, t0 + 30, top),
            _span("serve.readback", readback, t0 + 30, t0 + 70, top)]


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_span_metrics_read_the_passes(name, monkeypatch):
    assert set(READ) == set(SPAN_METRICS)
    if SPAN_METRICS[name]["layer"] == "train step":
        recorded = _step(0, 0) + _step(1, 200)
        tr = _trace([(0, 10), (75, 80), (120, 130), (200, 210), (265, 300)],
                    launches={0: 0.0, 1: 70.0, 2: 99.0, 3: 201.0, 4: 266.0})
        r = _readings(tr)
    else:
        recorded = _batch(0, 0, 10) + _batch(1, 200, 11)
        tr = _trace([(0, 50), (70, 215), (225, 260)])  # idle 50–70 in readback, 215–225 in dispatch
        r = _readings(tr, "stream")
    r.span_passes = spans.summarise(2, recorded, tr, recorded)
    assert spec.metric_reader(name).read(r) == pytest.approx(READ[name])


@pytest.mark.parametrize("traffic", ["train_recipe", "serve_stream"])
def test_the_passes_process_runs_a_tiny_cell(traffic, monkeypatch, capsys):
    """``main`` on the CPU: the runs off and on, each span of pass (a), and
    pass (b) read where its capture holds no kernel."""
    t = spec.load_json(spec.traffic_file(traffic))
    cell = tiny.cell("base-serve-b64" if traffic == "serve_stream" else "base-train-b128", batch=2)
    job = {"cfg": tiny.config(), "traffic": t, "cell": cell, "seed": 2**31 + 7, "units": 2, "device": "cpu"}
    monkeypatch.setattr(spans.sys, "stdin", io.StringIO(json.dumps(job)))
    monkeypatch.setattr(spans.trace, "capture", lambda fn: (fn(), Trace())[1])  # no CUDA device here
    threads = torch.get_num_threads()
    try:
        assert spans.main() == 0
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    top = "step" if traffic == "train_recipe" else "serve.batch"
    assert top in out["names"] and out["host_ms"][top] > 0
    assert len(out["off_ms"]) == len(out["on_ms"]) == 2
    assert out["idle_ms"] == {} and out["launches"] == {}
