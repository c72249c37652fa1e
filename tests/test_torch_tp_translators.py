"""Tensor parallelism of the mlp, conv and transformer translators over gloo
processes on the CPU (``parallel/tp.py`` ``shard_module``, the split heads of
``models/adapter_heads.py``, the replicated backbone adapter and transformer
stem, ``train_from_config`` at ``model_axis=2``), against the JAX package's
tensor-parallel step on a (1, 2) mesh of CPU devices and the port at one
process.

Processes (``tests/torch_tp_worker.py``, one intra-op thread each) are
started once a grid and run the three translators in turn: two ranks at
``model_axis=2`` (TP(2)) and four (a 2 x 2 data x model grid). The model is
a 2-layer deit-small Theia (6 heads) with a 16x16 and a 64x64 teacher, so
the conv head runs its 16 -> 16 and 16 -> 64 ladders (both through the pad
pre-conv) and the mlp heads resize to both grids; tiny translator widths;
float32 exact mode, a global batch of 4, two steps with the grad clip.

Tolerances: tests/test_torch_tp.py's (the JAX TP test's losses rtol 2e-5
and parameters atol 3e-4 after two float32 steps; parameter changes within
relative L2 0.1 and moments 0.05 of the JAX step's).
"""

import dataclasses
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tp import (
    BATCH, CLIP, EXACT, LR, SMALL, STEPS, TEACHER, _collect, _jax_tp_steps, _launch, _noise_only, _port_steps, _rel_l2,
    _save_batch, _sd, _targets,
)
from theia_tpu.data.synthetic import generate_synthetic_dataset
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.pretrained import load_theia_checkpoint
from theia_tpu_torch.models.rvfm import Theia as TTheia

SIZES = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64)}
TRANSLATORS = {
    "mlp": dict(translator_hidden_size=32, translator_n_layer=3),
    "conv": dict(translator_hidden_size=8),
    "transformer": dict(translator_hidden_size=32, translator_n_layers=1, translator_n_heads=2),
}
# the heads whose features stay split into the loss: a 3-layer mlp head and
# a conv head end column-parallel, the transformer's 2-layer head row-parallel
SPLIT = {"mlp": True, "conv": True, "transformer": False}
GRIDS = {"tp2": 2, "data2_model2": 4}


def _overrides(translator):
    return [f"model/translator={translator}",
            *(f"model.translator.kwargs.{k}={v}" for k, v in TRANSLATORS[translator].items())]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every grid's records, each translator's JAX TP trajectory and the
    port's one-process one, the initial parameters."""
    saved = [(configs, configs[SMALL]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[SMALL] = dataclasses.replace(cfg, num_layers=2)
    try:
        tmp = tmp_path_factory.mktemp("tp_translators")
        rng = np.random.default_rng(1)
        images = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        targets = _targets(rng, SIZES, BATCH)
        names = _save_batch(tmp / "batch.npz", images, targets)
        params, entries = {}, {}
        for i, (t, kw) in enumerate(TRANSLATORS.items()):
            jmodel = JTheia(backbone=SMALL, translator=t, target_feature_sizes=SIZES, translator_kwargs=kw)
            params[t] = jmodel.init(jax.random.PRNGKey(i), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
            torch.save(state_dict_from_jax(params[t], SIZES, translator=t), tmp / f"sd_{t}.pt")
            entries[t] = dict(kwargs=kw, state_dict=str(tmp / f"sd_{t}.pt"), overrides=[
                *_overrides(t), "model/backbone=deit", "training/target_models=dinov2",
                f"dataset.dataset_root={tmp}/shards", "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=4",
                "training.batch_size=2", "training.model_axis=2", f"logging.model_path={tmp}/ckpt_{t}",
                f"logging.log_path={tmp}/logs_{t}", "logging.save_ckpt_interval=0", "logging.log_interval=1",
                *EXACT])
        generate_synthetic_dataset(str(tmp / "shards"), feature_models=TEACHER, n_train=4, n_val=4,
                                   samples_per_shard=2)
        common = dict(batch=str(tmp / "batch.npz"), names=names, targets=SIZES, n_model=2, steps=STEPS, lr=LR,
                      clip=CLIP, translators=entries)
        procs = {}
        for grid, world in GRIDS.items():
            (tmp / grid).mkdir()
            cases = ["translators_steps"] + (["translators_loop"] if grid == "tp2" else [])
            spec = dict(common, world=world, cases=cases, out=str(tmp / grid))
            (tmp / grid / "spec.json").write_text(json.dumps(spec))
            procs[grid] = _launch(tmp / grid / "spec.json", world)
        jax_runs, one = {}, {}
        for t, kw in TRANSLATORS.items():
            jax_runs[t] = _jax_tp_steps(params[t], images, targets, t, SIZES, kw)
            sd = torch.load(tmp / f"sd_{t}.pt", weights_only=True)
            one[t] = _port_steps(sd, images, targets, STEPS, t, SIZES, kw)
        grids = {grid: _collect(p, tmp / grid) for grid, p in procs.items()}
        yield dict(grids=grids, jax=jax_runs, one=one, params=params)
    finally:
        for configs, cfg in saved:
            configs[SMALL] = cfg


@pytest.mark.parametrize("translator", list(TRANSLATORS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_steps_match_the_jax_tp_step(run, grid, translator):
    jstate, jlosses = run["jax"][translator]
    got = run["grids"][grid][0][f"tp_{translator}"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-5)
    init, want = _sd(run["params"][translator], SIZES, translator), _sd(jstate.params, SIZES, translator)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n].numpy(), w, atol=3e-4, err_msg=n)
        if not (_noise_only(n) or np.array_equal(w, init[n])):
            assert _rel_l2(got["params"][n].numpy() - init[n], w - init[n]) < 0.1, n
    for moments, jm in ((got["mu"], jstate.opt_state.mu), (got["nu"], jstate.opt_state.nu)):
        for n, w in _sd(jm, SIZES, translator).items():
            if not (_noise_only(n) or not w.any()):
                assert _rel_l2(moments[n].float().numpy(), w) < 0.05, n
    assert set(got["count"].values()) == {STEPS}


@pytest.mark.parametrize("translator", list(TRANSLATORS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_steps_match_one_process(run, grid, translator):
    losses, params = run["one"][translator]
    got = run["grids"][grid][0][f"tp_{translator}"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), atol=3e-4, err_msg=n)


@pytest.mark.parametrize("translator", list(TRANSLATORS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_ranks_hold_their_slices_and_agree(run, grid, translator):
    """Every split parameter is halved on its plan's dimension, the heads'
    among them; the backbone adapter and the transformer's stem stay whole;
    every rank ends with the same whole parameters, the replicated ones
    bit-equal across the grid; losses and clip norms agree."""
    records = run["grids"][grid]
    a = records[0][f"tp_{translator}"]
    assert [r["grid"] for r in records] == [(GRIDS[grid] // 2, 2, r // 2, r % 2) for r in range(GRIDS[grid])]
    whole = {n: tuple(p.shape) for n, p in a["params"].items()}
    for n, shape in a["local_shapes"].items():
        if n in a["split"]:
            assert sum(x != y for x, y in zip(shape, whole[n])) == 1 and np.prod(shape) * 2 == np.prod(whole[n]), n
        else:
            assert shape == whole[n], n
    heads = [n for n in a["split"] if n.startswith("translator.translator_heads.")]
    assert {n.split(".")[2] for n in heads} == {"teacher/a", "teacher/b"}
    assert not [n for n in a["split"] if n.startswith("translator.") and n not in heads]
    assert a["split_outputs"] == {t: SPLIT[translator] for t in SIZES}
    for b in (r[f"tp_{translator}"] for r in records[1:]):
        assert b["losses"] == a["losses"] and b["grad_norms"] == a["grad_norms"]
        for n in a["params"]:
            assert torch.equal(a["params"][n], b["params"][n]), n


@pytest.mark.parametrize("translator", list(TRANSLATORS))
def test_train_from_config_at_model_axis_2_saves_and_resumes(run, translator):
    """Two ranks of one data index read the same rows; one epoch, then a
    resume for a second; rank 0's checkpoint is in the whole layout and
    loads with ``load_theia_checkpoint`` at one process."""
    a, b = (r[f"loop_{translator}"] for r in run["grids"]["tp2"])
    assert a["steps"] == b["steps"] == [2, 4]
    assert len(a["train"]) == 4 and all(torch.equal(x, y) for x, y in zip(a["train"], b["train"]))
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    ckpt_dir = Path(a["ckpt_dir"])
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "4.pt"]
    saved = torch.load(ckpt_dir / "4.pt", weights_only=True)
    model = TTheia(backbone=SMALL, translator=translator, target_feature_sizes=TEACHER,
                   translator_kwargs=TRANSLATORS[translator])
    assert {n: tuple(p.shape) for n, p in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    assert all(saved["mu"][n].shape == p.shape for n, p in model.named_parameters())
    load_theia_checkpoint(str(ckpt_dir), model)
    assert all(torch.equal(p, saved["params"][n]) for n, p in model.named_parameters())
