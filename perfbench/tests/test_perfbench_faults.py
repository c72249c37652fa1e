"""The check catches a broken timed path.

Each test drives a whole run of a cell on the CPU at a tiny size (the
harness's look for a card skipped, its limits kept) with one fault planted
in the program underneath, and sees ``correct`` come out false: a step that
leaves the state unchanged, half of the batch left out (the mean taken over
the rest), an answer altered where it is produced. A sound run of the same
cell comes out correct. (The cells run on one card: no exchange between
cards to leave out.) The ``gpu`` test reads the control, the reference one
precision below the configuration's, at each cell's own size on the card,
and sees the cell's limits refuse it.
"""

from __future__ import annotations

import time

import pytest
import torch

from perfbench import check, spec
from perfbench.run import run_cell
from perfbench.tests import tiny

TRAIN, SERVE = "base-train-b128", "base-serve-b64"


def _run(tmp_path, name: str, batch: int) -> dict:
    result, _ = run_cell(name, 2**31 + 12345, 1.0, False, torch.device("cpu"), time.perf_counter(),
                         tiny.bench(tmp_path), tiny.cell(name, batch))
    return result


def test_sound_train_run_is_correct(tmp_path):
    assert _run(tmp_path, TRAIN, 4)["correct"]


def test_sound_serve_run_is_correct(tmp_path):
    assert _run(tmp_path, SERVE, 4)["correct"]


def test_state_left_unchanged(tmp_path, monkeypatch):
    from theia_tpu_torch.train import optim

    monkeypatch.setattr(optim.MaskedAdamW, "update", lambda self, *a, **k: None)
    result = _run(tmp_path, TRAIN, 4)
    assert not result["correct"]
    assert result["check"]["update_gap"]["value"] == pytest.approx(1.0)


def test_half_the_batch_left_out(tmp_path, monkeypatch):
    from theia_tpu_torch.train import step

    make = step.make_train_step

    def half(*args, **kwargs):
        fn = make(*args, **kwargs)

        def run(state, images, targets, loss_masks=None):
            n = images.shape[0] // 2
            return fn(state, images[:n], {t: v[:n] for t, v in targets.items()}, loss_masks)

        return run

    monkeypatch.setattr(step, "make_train_step", half)
    assert not _run(tmp_path, TRAIN, 4)["correct"]


def test_a_prediction_altered(tmp_path, monkeypatch):
    from theia_tpu_torch.models.rvfm import Theia

    forward = Theia.forward

    def altered(self, *args, **kwargs):
        preds = forward(self, *args, **kwargs)
        first = next(iter(preds))
        return {**preds, first: preds[first] + 0.5}

    monkeypatch.setattr(Theia, "forward", altered)
    assert not _run(tmp_path, TRAIN, 4)["correct"]


def test_half_the_served_batch_left_out(tmp_path, monkeypatch):
    from theia_tpu_torch.models.hub import PretrainedTheia

    forward_feature = PretrainedTheia.forward_feature

    def half(self, x, **kwargs):
        n = x.shape[0] // 2
        out = forward_feature(self, x[:n], **kwargs)
        return torch.cat([out, torch.zeros_like(out)])

    monkeypatch.setattr(PretrainedTheia, "forward_feature", half)
    assert not _run(tmp_path, SERVE, 4)["correct"]


def test_a_served_answer_altered(tmp_path, monkeypatch):
    from theia_tpu_torch.models.hub import PretrainedTheia

    forward_feature = PretrainedTheia.forward_feature

    def altered(self, x, **kwargs):
        out = forward_feature(self, x, **kwargs).clone()
        out[0] = out[-1]
        return out

    monkeypatch.setattr(PretrainedTheia, "forward_feature", altered)
    assert not _run(tmp_path, SERVE, 4)["correct"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark()["workloads"]])
def test_control_fails_the_cells_limits(name):
    """The control at the cell's own size on the card, one seed: refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.tools import calibrate

    limits = spec.load_json(spec.cell_file(name))["limits"]
    rows = calibrate.readings(name, 2**31 + 777, True, 3.0, torch.device("cuda", 0))
    control = [r for r in rows if r["side"].startswith("control")]
    assert control
    for r in control:
        numbers = {k: v for k, v in r.items() if k in limits}
        assert not check.judge(numbers, limits)
