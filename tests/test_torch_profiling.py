"""The port's profiling hooks (theia_tpu_torch/utils/profiling.py): StepTimer
against the JAX package's on one fake clock, the torch.profiler trace on
the CPU, and the program spans (which the JAX package has not): off, they
read no clock; on, they nest, lie on the profiler's clock, and leave the
Predictor's outputs and the train step's parameters and moments bit-equal.
The card's case (no synchronize) is tests/test_torch_spans_gpu.py."""

import contextlib
import dataclasses
import json

import numpy as np
import pytest
import torch

from theia_tpu.utils import profiling as jprof
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.serving import Predictor
from theia_tpu_torch.utils import profiling as tprof


class FakeClock:
    """A ``time`` stand-in whose ``perf_counter`` advances by the given
    increments, cycling."""

    def __init__(self, increments):
        self.now, self.increments, self.calls = 100.0, increments, 0

    def perf_counter(self):
        self.now += self.increments[self.calls % len(self.increments)]
        self.calls += 1
        return self.now


# (operation, argument): "step" takes a batch size, "rate" reads images_per_sec,
# "reset" starts over
SCRIPT = [("rate", None), ("step", 8), ("rate", None), ("step", 8), ("rate", None), ("step", 16),
          ("rate", None), ("step", 4), ("step", 0), ("rate", None), ("reset", None), ("rate", None),
          ("step", 32), ("step", 32), ("step", 32), ("rate", None), ("step", 1), ("rate", None)]


@pytest.mark.parametrize("warmup_steps", [0, 1, 2, 3])
@pytest.mark.parametrize("increments", [(0.25,), (0.5, 1.5, 0.125), (0.0,)], ids=["even", "uneven", "frozen"])
def test_step_timer_matches_jax(monkeypatch, warmup_steps, increments):
    clocks = {}
    timers = {}
    for name, module in (("jax", jprof), ("port", tprof)):
        clocks[name] = FakeClock(increments)
        monkeypatch.setattr(module, "time", clocks[name])
        timers[name] = module.StepTimer(warmup_steps=warmup_steps)
    rates = {"jax": [], "port": []}
    for op, arg in SCRIPT:
        for name, timer in timers.items():
            if op == "step":
                timer.step(arg)
            elif op == "reset":
                timer.reset()
            else:
                rates[name].append(timer.images_per_sec)
    assert rates["port"] == rates["jax"]
    assert clocks["port"].calls == clocks["jax"].calls
    assert rates["port"][0] == 0.0  # before any step
    assert any(r > 0 for r in rates["port"]) == (warmup_steps > 0)  # no clock start without a warmup step


def test_step_timer_default_warmup_matches_jax():
    assert tprof.StepTimer().warmup_steps == jprof.StepTimer().warmup_steps == 2


def _trace_files(logdir):
    return sorted(logdir.glob("*.pt.trace.json"))


def test_trace_writes_one_trace_file(tmp_path):
    with tprof.trace(str(tmp_path)):
        x = torch.randn(64, 64)
        (x @ x).sum()
    files = _trace_files(tmp_path)
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)
    assert not torch._C._autograd._profiler_enabled()


def test_trace_stops_the_profiler_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with tprof.trace(str(tmp_path / "a")):
            torch.ones(3).sum()
            raise KeyError("boom")
    assert not torch._C._autograd._profiler_enabled()
    assert len(_trace_files(tmp_path / "a")) == 1
    # a second trace starts: the first one's profiler is gone
    with tprof.trace(str(tmp_path / "b")):
        torch.ones(3).sum()
    assert len(_trace_files(tmp_path / "b")) == 1


# ---------------------------------------------------------------- program spans

NAME = "facebook/deit-tiny-patch16-224"
TARGETS = {"teacher/a": (24, 16, 16)}


class NoClock:
    """A ``time`` stand-in that fails on any read."""

    def __getattr__(self, name):
        raise AssertionError(f"time.{name} read while recording is off")


@pytest.fixture
def tiny_theia(monkeypatch):
    """A 2-layer deit-tiny Theia with one 16² teacher, seeded."""
    monkeypatch.setitem(tvit.BACKBONE_CONFIGS, NAME, dataclasses.replace(tvit.BACKBONE_CONFIGS[NAME], num_layers=2))

    def build():
        model = Theia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS)
        model.reset_parameters(torch.Generator().manual_seed(0))
        return model

    return build


def test_span_off_is_one_shared_noop_and_reads_no_clock(monkeypatch):
    monkeypatch.setattr(tprof, "time", NoClock())
    first, second = tprof.span("step", 3), tprof.span("serve.batch")
    assert first is second
    with first, second:
        pass
    with tprof.recording() as rec:
        pass
    assert rec.spans() == [] and tprof.span("step") is first


def test_spans_nest_carry_their_unit_and_drain():
    with tprof.recording() as rec:
        for unit in (0, 1):
            with tprof.span("step", unit):
                with tprof.span("step.forward", unit):
                    with tprof.recording() as inner:  # an inner block takes its own spans
                        with tprof.span("inner"):
                            pass
                with tprof.span("step.optimizer", unit):
                    pass
        spans = rec.spans()
        assert rec.drain() == spans and rec.spans() == []
        with tprof.span("after"):
            pass
    assert [s.name for s in inner.spans()] == ["inner"]
    assert [(s.name, s.unit) for s in spans] == [("step.forward", 0), ("step.optimizer", 0), ("step", 0),
                                                 ("step.forward", 1), ("step.optimizer", 1), ("step", 1)]
    for s in spans:
        assert s.start_ns <= s.end_ns and s.ms >= 0
        if s.name == "step":
            assert s.parent is None
        else:
            assert s.parent.name == "step" and s.parent.unit == s.unit
            assert s.parent.start_ns <= s.start_ns and s.end_ns <= s.parent.end_ns
    assert [s.name for s in rec.drain()] == ["after"]
    assert tprof.span("x") is tprof.span("y")  # off again after the block


def test_spans_are_on_the_profilers_clock():
    """A span around ``x @ x`` holds the ``aten::mm`` event of a CPU
    torch.profiler capture of the same calls, on every call."""
    x = torch.randn(128, 128)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tprof.recording() as rec:
            for unit in range(8):
                with tprof.span("mm", unit):
                    x @ x
    mms = sorted((e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"),
                 key=lambda e: e.start_ns())
    spans = rec.spans()
    assert len(mms) == len(spans) == 8
    for s, e in zip(spans, mms):
        assert s.start_ns <= e.start_ns() and e.start_ns() + e.duration_ns() <= s.end_ns


def test_predict_stream_records_stage_dispatch_and_readback(tiny_theia, monkeypatch):
    model = tiny_theia().eval()
    batches = [np.random.RandomState(k).randint(0, 256, (2, 224, 224, 3), np.uint8) for k in range(4)]
    with monkeypatch.context() as m:
        m.setattr(tprof, "time", NoClock())
        off = list(Predictor(model, buckets=(2,), depth=2).predict_stream(batches))
    with tprof.recording() as rec:
        on = list(Predictor(model, buckets=(2,), depth=2).predict_stream(batches))
    for a, b in zip(off, on, strict=True):
        np.testing.assert_array_equal(a, b)
    spans = rec.spans()
    batch = {s.unit: s for s in spans if s.name == "serve.batch"}
    assert sorted(batch) == [0, 1, 2, 3]
    for name in ("serve.stage", "serve.dispatch"):
        got = [s for s in spans if s.name == name]
        assert [s.unit for s in got] == [0, 1, 2, 3] and all(s.parent is batch[s.unit] for s in got)
    # batch k is read back while batch k + 2 is taken; the last two after the input ends
    readback = [s for s in spans if s.name == "serve.readback"]
    assert [s.unit for s in readback] == [0, 1, 2, 3]
    assert [s.parent for s in readback] == [batch[2], batch[3], None, None]


def test_train_step_records_its_phases(tiny_theia):
    from theia_tpu_torch.train.optim import make_optimizer
    from theia_tpu_torch.train.state import TrainState
    from theia_tpu_torch.train.step import make_train_step

    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8))
    targets = {t: torch.from_numpy(rng.standard_normal((2, *shape), dtype=np.float32)) for t, shape in TARGETS.items()}
    states = []
    for record in (False, True):
        model = tiny_theia()
        tx = make_optimizer(1e-3, moment_dtype=torch.bfloat16)
        state = TrainState.create(dict(model.named_parameters()), tx)
        step = make_train_step(model, tx)
        with tprof.recording() if record else contextlib.nullcontext() as rec:
            for _ in range(2):
                state, _ = step(state, images, targets)
        states.append(state)
    off, on = states
    for n in off.params:
        for a, b in ((off.params, on.params), (off.opt_state.mu, on.opt_state.mu), (off.opt_state.nu, on.opt_state.nu)):
            assert torch.equal(a[n], b[n]), n
    spans = rec.spans()
    steps = [s for s in spans if s.name == "step"]
    assert [s.unit for s in steps] == [0, 1]
    for top in steps:
        children = [s for s in spans if s.parent is top]
        # one rank, no grad clip: no step.reduce, no step.clip
        assert [s.name for s in children] == ["step.forward", "step.loss", "step.backward", "step.optimizer"]
        assert all(s.unit == top.unit for s in children)
        bounds = [top.start_ns] + [t for s in children for t in (s.start_ns, s.end_ns)] + [top.end_ns]
        assert bounds == sorted(bounds)  # in order, inside the step, not overlapping
