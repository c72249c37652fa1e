"""The port's training runtime (train/checkpoint.py, train/loop.py,
scripts/train_rvfm.py) on the CPU: checkpoints bit for bit, and
``train_from_config`` against the JAX package's on the same shards from the
same initial parameters, on a 2-layer deit-tiny with the DINOv2 teacher.

Tolerances (those tests/test_torch_train_step.py holds 3-step
trajectories to): float32 exact mode, every logged step's loss rtol 1e-5;
the production recipe (bf16 compute, fast_math, fuse_preprocessing, bf16
moments), rtol 2e-2. The JAX loop runs on one CPU device (its mesh of one)
so that both loops see the same batch of 2.
"""

import dataclasses
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.config import load_config as jload_config
from theia_tpu.data.synthetic import generate_synthetic_dataset
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.parallel import mesh as jmesh
from theia_tpu.train import loop as jloop
from theia_tpu_torch.config import load_config
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.scripts import train_rvfm
from theia_tpu_torch.train import checkpoint as tckpt
from theia_tpu_torch.train import loop as tloop
from theia_tpu_torch.train.optim import make_optimizer
from theia_tpu_torch.train.state import TrainState

TINY = "facebook/deit-tiny-patch16-224"
TEACHER = {"facebook/dinov2-large": (1024, 16, 16)}
EXACT = ["training.compute_dtype=float32", "training.fast_math=false", "training.fuse_preprocessing=false",
         "training.moment_dtype=float32"]
REPO = str(Path(__file__).resolve().parent.parent)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Batches of 2 need no intra-op threads; under a parallel test run, a
    pool of one per core in every worker only contends for the cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module", autouse=True)
def two_layer_backbones():
    saved = [(configs, configs[TINY]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[TINY] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, cfg in saved:
        configs[TINY] = cfg


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """6 train samples (3 steps of 2), 4 val (one eval step), JAX-written."""
    root = str(tmp_path_factory.mktemp("shards"))
    generate_synthetic_dataset(root, feature_models=TEACHER, n_train=6, n_val=4, samples_per_shard=4)
    return root


def _overrides(root, out, extra=()):
    return ["model/backbone=deit_tiny", "training/target_models=dinov2", f"dataset.dataset_root={root}",
            "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=4", "training.epochs=1",
            "training.batch_size=2", f"logging.model_path={out}/ckpt", f"logging.log_path={out}/logs",
            "logging.save_ckpt_interval=0", "logging.log_interval=1", *extra]


# ---------------------------------------------------------------- checkpoints


def _state(seed=0, moment_dtype=torch.bfloat16):
    """A small model's TrainState with every entry set: the checkpoint code
    sees only names, shapes and dtypes, whatever the model."""
    torch.manual_seed(seed)
    model = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.LayerNorm(16), torch.nn.Linear(16, 4))
    tx = make_optimizer(1e-3, moment_dtype=moment_dtype)
    state = TrainState.create(dict(model.named_parameters()), tx)
    g = torch.Generator().manual_seed(seed + 100)
    with torch.no_grad():
        for n, p in state.params.items():
            state.opt_state.mu[n].copy_(torch.randn(p.shape, generator=g))
            state.opt_state.nu[n].copy_(torch.rand(p.shape, generator=g))
            state.opt_state.count[n] = torch.randint(0, 9, (), generator=g, dtype=torch.int32)
    state.step += 7 + seed
    state.opt_state.sched_count += 5 + seed
    return model, state


def _flat(state):
    o = state.opt_state
    trees = {"params": state.params, "count": o.count, "mu": o.mu, "nu": o.nu}
    return {"step": state.step, "sched_count": o.sched_count,
            **{f"{k}.{n}": t for k, tree in trees.items() for n, t in tree.items()}}


def _assert_bit_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


def test_checkpoint_round_trips_bit_for_bit(tmp_path):
    _, src = _state(0)
    want = {k: t.clone() for k, t in _flat(src).items()}
    assert want["mu.1.weight"].dtype == torch.bfloat16 and want["params.1.weight"].dtype == torch.float32
    assert want["count.1.weight"].dtype == torch.int32 and want["step"].dtype == torch.int32
    tckpt.save_checkpoint(str(tmp_path), src, 7)
    assert tckpt.latest_step(str(tmp_path)) == 7
    _, dst = _state(1)
    assert tckpt.restore_checkpoint(str(tmp_path), dst) is dst
    _assert_bit_equal(_flat(dst), want)


def test_restore_changes_the_live_model(tmp_path):
    """A restore copies into the model's own parameters (TrainState.params
    are them): its forward changes to the saved model's."""
    saved_model, saved = _state(0)
    tckpt.save_checkpoint(str(tmp_path), saved, 3)
    model, state = _state(1)
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        want, before = saved_model(x), model(x)
        assert not torch.equal(before, want)
        tckpt.restore_checkpoint(str(tmp_path), state)
        assert torch.equal(model(x), want)


def test_async_save_is_a_snapshot(tmp_path):
    """An in-place update right after save() returns does not reach the file."""
    _, state = _state(0)
    want = {k: t.clone() for k, t in _flat(state).items()}
    with tckpt.CheckpointSession(str(tmp_path)) as session:
        session.save(state, 1)
        with torch.no_grad():
            for p in state.params.values():
                p.add_(1.0)
            for m in state.opt_state.mu.values():
                m.mul_(2)
        state.step += 1
    assert [s for s, _, _ in session.timings] == [1] and session.timings[0][2] is not None
    _, dst = _state(1)
    tckpt.restore_checkpoint(str(tmp_path), dst)
    _assert_bit_equal(_flat(dst), want)


def test_corrupt_newest_step_falls_back_with_a_warning(tmp_path):
    _, s2 = _state(2)
    want = {k: t.clone() for k, t in _flat(s2).items()}
    tckpt.save_checkpoint(str(tmp_path), s2, 2)
    _, s4 = _state(4)
    tckpt.save_checkpoint(str(tmp_path), s4, 4)
    path = tmp_path / "4.pt"
    path.write_bytes(path.read_bytes()[:500])  # truncated after commit
    _, dst = _state(1)
    with pytest.warns(UserWarning, match="step 4"):
        tckpt.restore_checkpoint(str(tmp_path), dst)
    _assert_bit_equal(_flat(dst), want)
    (tmp_path / "2.pt").write_bytes(b"garbage")
    try:
        torch.load(path, weights_only=True)
    except Exception as e:
        newest = e
    with pytest.warns(UserWarning, match="step 2"), pytest.raises(type(newest)) as err:
        tckpt.restore_checkpoint(str(tmp_path), dst)
    assert str(err.value) == str(newest)  # every step failed: the newest step's error


def test_leftover_temporary_is_ignored_and_five_are_kept(tmp_path):
    _, state = _state(0)
    (tmp_path / "9.pt.tmp-123-456").write_bytes(b"half a write")
    assert tckpt.latest_step(str(tmp_path)) is None
    with tckpt.CheckpointSession(str(tmp_path)) as session:
        for step in range(1, 8):
            session.save(state, step)
    assert tckpt.all_steps(str(tmp_path)) == [3, 4, 5, 6, 7]
    assert session.latest_step() == 7
    assert (tmp_path / "9.pt.tmp-123-456").exists()
    _, dst = _state(1)
    tckpt.restore_checkpoint(str(tmp_path), dst)
    _assert_bit_equal(_flat(dst), _flat(state))


def test_mismatched_structure_raises_and_copies_nothing(tmp_path):
    _, state = _state(0, moment_dtype=None)  # float32 moments
    tckpt.save_checkpoint(str(tmp_path), state, 1)
    _, dst = _state(1)
    before = {k: t.clone() for k, t in _flat(dst).items()}
    with pytest.warns(UserWarning), pytest.raises(ValueError, match="mu"):
        tckpt.restore_checkpoint(str(tmp_path), dst)
    _assert_bit_equal(_flat(dst), before)


# ------------------------------------------------------------ the train loop


def _jax_params(cfg):
    """The JAX loop's initial params (loop.py:150-161, :376)."""
    _, _, sizes = jloop.select_target_models(cfg)
    dtype = jnp.bfloat16 if cfg.training.compute_dtype == "bfloat16" else jnp.float32
    model = JTheia(backbone=cfg.model.backbone.backbone, translator="lconv", target_feature_sizes=sizes,
                   dtype=dtype, fuse_preprocessing=bool(cfg.training.fuse_preprocessing),
                   fast_math=bool(cfg.training.fast_math))
    return model.init(jax.random.PRNGKey(cfg.seed), jnp.zeros((2, 224, 224, 3), jnp.uint8))["params"], sizes


def _write_port_step0(cfg, params, sizes):
    """The JAX initial params as the port's step-0 checkpoint, through state_dict_from_jax."""
    model = TTheia(backbone=cfg.model.backbone.backbone, translator="lconv", target_feature_sizes=sizes)
    model.load_state_dict(state_dict_from_jax(params, sizes), strict=True)
    moment = torch.bfloat16 if cfg.training.moment_dtype == "bfloat16" else None
    state = TrainState.create(dict(model.named_parameters()), make_optimizer(1e-3, moment_dtype=moment))
    ckpt_dir = os.path.join(cfg.logging.model_path, tloop.build_run_identifier(cfg))
    tckpt.save_checkpoint(ckpt_dir, state, 0)


def _losses(log_dir):
    (path,) = Path(log_dir).glob("*.metrics.jsonl")
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


@pytest.mark.parametrize("mode,rtol", [("exact", 1e-5), ("recipe", 2e-2)])
def test_loop_losses_match_jax(shards, tmp_path, monkeypatch, mode, rtol):
    extra = EXACT if mode == "exact" else []
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: jmesh.make_mesh(n_model=n_model,
                                                                               devices=jax.devices()[:1]))
    jcfg = jload_config("train_rvfm_imagenet", _overrides(shards, tmp_path / "jax", extra))
    jsummary = jloop.train_from_config(jcfg, resume=False)

    tcfg = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path / "port", extra))
    _write_port_step0(tcfg, *_jax_params(jcfg))
    tsummary = tloop.train_from_config(tcfg, device="cpu")

    assert tsummary["step"] == jsummary["step"] == 3
    assert tsummary["timing"]["restore_s"] is not None and tsummary["timing"]["steps"] == 3
    want, got = _losses(tmp_path / "jax" / "logs"), _losses(tmp_path / "port" / "logs")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    np.testing.assert_allclose(got[1], want[1], rtol=rtol)
    np.testing.assert_allclose([got[s] for s in (1, 2, 3)], [want[s] for s in (1, 2, 3)], rtol=rtol)
    for k, v in jsummary["eval"].items():
        np.testing.assert_allclose(tsummary["eval"][k], v, rtol=rtol, err_msg=k)
    assert set(tsummary) == set(jsummary) | {"timing"}


def test_resume_trains_only_the_remaining_epoch(shards, tmp_path, capsys):
    """tests/test_train_loop.py's resume semantics: step 2, then step 4 with epochs=2."""
    cfg = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path))
    summary = tloop.train_from_config(cfg, max_steps=2, device="cpu")
    assert summary["step"] == 2 and summary["eval"]["avg_eval_cos_loss"] > 0
    assert list((tmp_path / "logs").glob("*.metrics.jsonl"))
    cfg2 = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path, ["training.epochs=2"]))
    summary2 = tloop.train_from_config(cfg2, max_steps=2, device="cpu")
    assert summary2["step"] == 4 and summary2["timing"]["steps"] == 2
    assert "resuming at step 2 (epoch 1, 0 steps into it)" in capsys.readouterr().out
    assert tckpt.all_steps(summary2["ckpt_dir"]) == [2, 4]


def test_distill_cls_and_random_targets(shards, tmp_path):
    cfg = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path, ["training.distill_cls=true",
                                                                           "training.random_target_models=2"]))
    summary = tloop.train_from_config(cfg, resume=False, max_steps=2, device="cpu")
    assert summary["step"] == 2
    assert "avg_eval_facebook/dinov2-large_cls_cos_loss" in summary["eval"]


def test_cli_trains_on_the_cpu_only_when_asked(shards, tmp_path):
    args = _overrides(shards, tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_rvfm.main(args)
    summary = train_rvfm.main(args + ["--device", "cpu"])
    assert summary["step"] == 3


def test_cli_trains_with_two_workers_as_the_jax_loop_does(shards, tmp_path, monkeypatch):
    """``dataset.num_workers=2`` through the CLI: 3 steps whose losses equal
    the JAX loop's at 2 workers, exact mode. Both loaders fork their workers
    (no ``__main__`` file: the packages' stdin rule)."""
    monkeypatch.setattr(sys.modules["__main__"], "__file__", None, raising=False)
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: jmesh.make_mesh(n_model=n_model,
                                                                               devices=jax.devices()[:1]))
    extra = [*EXACT, "dataset.num_workers=2"]
    jcfg = jload_config("train_rvfm_imagenet", _overrides(shards, tmp_path / "jax", extra))
    jsummary = jloop.train_from_config(jcfg, resume=False)
    targs = _overrides(shards, tmp_path / "port", extra)
    _write_port_step0(load_config("train_rvfm_imagenet", targs), *_jax_params(jcfg))
    tsummary = train_rvfm.main(targs + ["--device", "cpu"])
    assert tsummary["step"] == jsummary["step"] == 3
    want, got = _losses(tmp_path / "jax" / "logs"), _losses(tmp_path / "port" / "logs")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    np.testing.assert_allclose([got[s] for s in (1, 2, 3)], [want[s] for s in (1, 2, 3)], rtol=1e-5)


def test_pretrained_flag_trains_and_names_the_run(shards, tmp_path):
    """``model.backbone.pretrained=true`` is the JAX package's config-parity
    flag: it trains and shows only in the run identifier."""
    cfg = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path, ["model.backbone.pretrained=true"]))
    summary = tloop.train_from_config(cfg, resume=False, max_steps=1, device="cpu")
    assert summary["step"] == 1
    assert summary["run"].endswith("_pretrained") and summary["run"] == jloop.build_run_identifier(cfg)


@pytest.mark.parametrize("override,err", [
    ("training.model_axis=2", NotImplementedError),
    ("training.grad_allreduce_dtype=bf9", ValueError),
    ("env:WORLD_SIZE=2", NotImplementedError),
])
def test_unported_options_raise(shards, tmp_path, monkeypatch, override, err):
    if override.startswith("env:"):
        key, _, value = override[4:].partition("=")
        monkeypatch.setenv(key, value)
        override = "training.epochs=1"
    cfg = load_config("train_rvfm_imagenet", _overrides(shards, tmp_path, [override]))
    with pytest.raises(err):
        tloop.train_from_config(cfg, device="cpu")


CHILD = """
import dataclasses, sys
from theia_tpu_torch.models import vit
name = "facebook/deit-tiny-patch16-224"
vit.BACKBONE_CONFIGS[name] = dataclasses.replace(vit.BACKBONE_CONFIGS[name], num_layers=2)
from theia_tpu_torch.config import load_config
from theia_tpu_torch.train.loop import train_from_config
root, out = sys.argv[1], sys.argv[2]
cfg = load_config("train_rvfm_imagenet", overrides=[
    "model/backbone=deit_tiny", "training/target_models=dinov2", f"dataset.dataset_root={root}",
    "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=4", "training.epochs=2", "training.batch_size=2",
    f"logging.model_path={out}/ckpt", f"logging.log_path={out}/logs",
    "logging.save_ckpt_interval=1",  # commit every step
])
summary = train_from_config(cfg, device="cpu")  # resume=True: auto-resume on restart
print("FINAL_STEP=" + str(summary["step"]))
"""


def test_kill_mid_epoch_auto_resume(shards, tmp_path):
    """tests/test_preemption.py for the port: SIGKILL once a mid-epoch step
    is committed; the rerun resumes from the newest committed step and ends
    at the exact total, 2 epochs x 3 steps."""
    script = tmp_path / "child.py"
    script.write_text(CHILD)
    ckpt_dir = tmp_path / "ckpt" / "rvfm_dp1.000_facebook-deit-tiny-patch16-224_lconv"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    cmd = [sys.executable, str(script), shards, str(tmp_path)]

    def committed():
        steps = [int(m.group(1)) for m in map(re.compile(r"^(\d+)\.pt$").match, os.listdir(ckpt_dir)) if m] \
            if ckpt_dir.is_dir() else []
        return max(steps) if steps else None

    p = subprocess.Popen(cmd, env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    killed_at, deadline = None, time.time() + 300
    while time.time() < deadline:
        s = committed()
        if s is not None and s >= 1:
            killed_at = s
            p.send_signal(signal.SIGKILL)
            break
        if p.poll() is not None:
            raise AssertionError("training finished before the kill; output:\n" + p.stdout.read())
        time.sleep(0.005)
    p.wait(timeout=60)
    p.stdout.close()
    assert killed_at is not None, "no checkpoint committed within the deadline"
    assert p.returncode == -signal.SIGKILL
    resumable = committed()
    assert killed_at <= resumable < 6, "the kill landed after the schedule completed"

    out = subprocess.run(cmd, env=env, cwd=str(tmp_path), timeout=300, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    assert out.returncode == 0, out.stdout
    resumed_from = int(out.stdout.split("resuming at step ")[1].split()[0])
    assert resumable <= resumed_from < 6
    assert "FINAL_STEP=6" in out.stdout, out.stdout
    assert committed() == 6
