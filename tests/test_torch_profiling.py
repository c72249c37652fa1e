"""The port's profiling hooks (theia_tpu_torch/utils/profiling.py): StepTimer
against the JAX package's on one fake clock, and the torch.profiler trace
on the CPU."""

import json

import pytest
import torch

from theia_tpu.utils import profiling as jprof
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
