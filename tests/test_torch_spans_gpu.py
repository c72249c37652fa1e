"""The program spans on the card (theia_tpu_torch/utils/profiling.py): a
recorded train step and a recorded ``Predictor`` stream make no synchronize
of their own, and a kernel's launch falls inside the span that launched it
on torch.profiler's clock. Needs a CUDA device; imports no JAX, so it runs
on the card's machine without the JAX-importing conftest:
``python -m pytest --noconftest tests/test_torch_spans_gpu.py``."""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from theia_tpu_torch.models import vit
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.serving import Predictor
from theia_tpu_torch.train.optim import make_optimizer
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_train_step
from theia_tpu_torch.utils import profiling

NAME = "facebook/deit-tiny-patch16-224"
TARGETS = {"teacher/a": (24, 16, 16)}


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setitem(vit.BACKBONE_CONFIGS, NAME, dataclasses.replace(vit.BACKBONE_CONFIGS[NAME], num_layers=2))
    return torch.device("cuda")


def _model(device):
    model = Theia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def _syncs(fn) -> int:
    """Synchronizing CUDA calls that ``fn`` makes, by torch's sync debug mode."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


@pytest.mark.gpu
def test_recorded_step_and_stream_make_no_synchronize(cuda):
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).to(cuda)
    targets = {t: torch.from_numpy(rng.standard_normal((2, *s), dtype=np.float32)).to(cuda) for t, s in TARGETS.items()}
    model = _model(cuda)
    tx = make_optimizer(1e-3, moment_dtype=torch.bfloat16)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx)
    step(state, images, targets)  # the build and the first launches outside the checks
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with profiling.recording() as rec:
            step(state, images, targets)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert [s.name for s in rec.spans()][-1] == "step"

    batches = [rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8) for _ in range(4)]
    predictor = Predictor(model.eval(), buckets=(2,), depth=2)
    list(predictor.predict_stream(batches))
    off = _syncs(lambda: list(predictor.predict_stream(batches)))
    with profiling.recording() as rec:
        on = _syncs(lambda: list(predictor.predict_stream(batches)))
    assert on == off <= len(batches)  # the readbacks' own copies to the host, no more
    assert sum(s.name == "serve.readback" for s in rec.spans()) == len(batches)


@pytest.mark.gpu
def test_kernels_launch_inside_their_spans(cuda):
    """Under a torch.profiler capture with the host's activity, every kernel
    of a recorded step was launched (by CUPTI's record) inside the step's
    span, and those of its forward inside ``step.forward``."""
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(1)
    images = torch.from_numpy(rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).to(cuda)
    targets = {t: torch.from_numpy(rng.standard_normal((2, *s), dtype=np.float32)).to(cuda) for t, s in TARGETS.items()}
    model = _model(cuda)
    tx = make_optimizer(1e-3)
    state = TrainState.create(dict(model.named_parameters()), tx)
    step = make_train_step(model, tx)
    step(state, images, targets)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with profiling.recording() as rec:
            step(state, images, targets)
        torch.cuda.synchronize()
    spans = {s.name: s for s in rec.spans()}
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA}
    launches = [e.start_ns() for e in events
                if e.correlation_id() in kernels and ("LaunchKernel" in e.name() or "cuLaunch" in e.name())]
    assert launches
    assert all(spans["step"].start_ns <= t <= spans["step"].end_ns for t in launches)
    forward = spans["step.forward"]
    assert any(forward.start_ns <= t <= forward.end_ns for t in launches)
