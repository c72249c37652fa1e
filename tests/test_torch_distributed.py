"""Data parallelism of the port over two gloo processes on the CPU
(``parallel/distributed.py``, the gradient all-reduce of ``train/step.py``,
the rank arithmetic of ``train/loop.py``, rank-0 checkpoints), against the
JAX package's step on a mesh of two CPU devices and its data functions.

Two processes (``tests/torch_dp_worker.py``, one intra-op thread each) are
started once with torchrun's environment; each trains a 2-layer deit-tiny
Theia on its 2 rows of a global batch of 4, 3 steps a wire dtype, then runs
``train_from_config`` for one epoch and resumes it for a second. The JAX
step runs meanwhile in this process.

Tolerances (those tests/test_torch_train_step.py holds 3-step trajectories
to, float32 exact mode): losses rtol 1e-5; parameter changes within
relative L2 0.1 of JAX's, moments 0.05; step counts exact. The bf16 wire's
all-reduced gradient is bit-equal to the sum, rounded to bf16, of the two
ranks' gradients each halved and rounded to bf16 (what the JAX step's bf16
psum computes); the float32 wire's is within relative L2 1e-5 of one
process's gradient on the whole batch (the same sums in another order).
The ranks' parameters and moments are bit-equal.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.config import load_config as jload_config
from theia_tpu.data import dataset as jds
from theia_tpu.data.synthetic import generate_synthetic_dataset
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.parallel.mesh import make_mesh
from theia_tpu.train import loop as jloop
from theia_tpu.train import optim as joptim
from theia_tpu.train.state import TrainState as JTrainState
from theia_tpu.train.step import make_train_step as jmake_train_step
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.parallel import distributed as pdist
from theia_tpu_torch.train import checkpoint as tckpt
from theia_tpu_torch.train.step import prepare_targets

TINY = "facebook/deit-tiny-patch16-224"
TARGETS = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64)}
TEACHER = {"facebook/dinov2-large": (1024, 16, 16)}
ROWS, STEPS, LR = 2, 3, 1e-4
WIRES = {"bfloat16": jnp.bfloat16, "float32": None}
REPO = Path(__file__).resolve().parent.parent
EXACT = ["training.compute_dtype=float32", "training.fast_math=false", "training.fuse_preprocessing=false",
         "training.moment_dtype=float32"]


def _overrides(root, out):
    return ["model/backbone=deit_tiny", "training/target_models=dinov2", f"dataset.dataset_root={root}",
            "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=4", "training.batch_size=2",
            f"logging.model_path={out}/ckpt", f"logging.log_path={out}/logs", "logging.save_ckpt_interval=0",
            "logging.log_interval=1", *EXACT]


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _noise_only(name):
    return name.endswith("attention.attention.key.bias")


def _sd(tree):
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, TARGETS).items()}


def _jax_trajectory(params, images, targets, wire):
    jmodel = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)
    jtx = joptim.make_optimizer(LR, weight_decay=0.01)
    step = jmake_train_step(jmodel, jtx, donate=False, mesh=make_mesh(n_data=2, devices=jax.devices()[:2]),
                            grad_allreduce_dtype=wire)
    state = JTrainState.create(params, jtx)
    losses = []
    for _ in range(STEPS):
        state, m = step(state, jnp.asarray(images), {t: jnp.asarray(v) for t, v in targets.items()})
        losses.append(float(m["loss"]))
    return state, losses


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both ranks' records, the JAX trajectories, the inputs."""
    saved = [(configs, configs[TINY]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[TINY] = dataclasses.replace(cfg, num_layers=2)
    try:
        tmp = tmp_path_factory.mktemp("dp")
        jmodel = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
        torch.save(state_dict_from_jax(params, TARGETS), tmp / "sd.pt")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (2 * ROWS, 224, 224, 3), dtype=np.uint8)
        targets = {t: rng.standard_normal((2 * ROWS, c, h, w), dtype=np.float32) for t, (c, h, w) in TARGETS.items()}
        np.savez(tmp / "batch.npz", images=images, **{f"target{i}": v for i, v in enumerate(targets.values())})
        root = str(tmp / "shards")
        generate_synthetic_dataset(root, feature_models=TEACHER, n_train=8, n_val=4, samples_per_shard=2)
        spec = dict(state_dict=str(tmp / "sd.pt"), batch=str(tmp / "batch.npz"), targets=TARGETS,
                    rows_per_rank=ROWS, steps=STEPS, lr=LR, out=str(tmp), overrides=_overrides(root, tmp))
        (tmp / "spec.json").write_text(json.dumps(spec))
        port = _free_port()
        procs = []
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), OMP_NUM_THREADS="1")
            procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_dp_worker.py"),
                                           str(tmp / "spec.json")], env=env, cwd=str(tmp),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        jax_runs = {wire: _jax_trajectory(params, images, targets, dtype) for wire, dtype in WIRES.items()}
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(2)]
        yield dict(ranks=ranks, jax=jax_runs, params=params, images=images, targets=targets, root=root, tmp=tmp)
    finally:
        for configs, cfg in saved:
            configs[TINY] = cfg


@pytest.mark.parametrize("wire", list(WIRES))
def test_two_rank_steps_match_jax_mesh_of_two(run, wire):
    jstate, jlosses = run["jax"][wire]
    got = run["ranks"][0][wire]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=1e-5)
    init, want = _sd(run["params"]), _sd(jstate.params)
    for n, w in want.items():
        if _noise_only(n) or np.array_equal(w, init[n]):
            continue
        assert _rel_l2(got["params"][n].numpy() - init[n], w - init[n]) < 0.1, n
    for moments, jm in ((got["mu"], jstate.opt_state.mu), (got["nu"], jstate.opt_state.nu)):
        for n, w in _sd(jm).items():
            if not (_noise_only(n) or not w.any()):
                assert _rel_l2(moments[n].float().numpy(), w) < 0.05, n
    assert got["step"] == int(jstate.step) == STEPS
    assert set(got["count"].values()) == {STEPS}


@pytest.mark.parametrize("wire", list(WIRES))
def test_ranks_stay_bit_equal(run, wire):
    a, b = (r[wire] for r in run["ranks"])
    assert a["losses"] == b["losses"]
    for key in ("params", "mu", "nu", "reduced"):
        assert all(torch.equal(a[key][n], b[key][n]) for n in a[key]), key


def test_bf16_wire_gradient_is_the_bf16_sum_of_the_halved_local_gradients(run):
    g0, g1 = (r["bfloat16"]["local"] for r in run["ranks"])
    reduced = run["ranks"][0]["bfloat16"]["reduced"]
    assert not torch.equal(g0["backbone.model.embeddings.cls_token"], g1["backbone.model.embeddings.cls_token"])
    for n, g in reduced.items():
        want = ((g0[n] / 2).bfloat16() + (g1[n] / 2).bfloat16()).float()
        assert g.dtype == torch.float32 and torch.equal(g, want), n


def test_float32_wire_gradient_matches_one_process_on_the_whole_batch(run):
    model = TTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)
    model.load_state_dict(torch.load(run["tmp"] / "sd.pt", weights_only=True), strict=True)
    targets = prepare_targets({t: torch.from_numpy(v) for t, v in run["targets"].items()})
    loss = main_loss_from_terms(get_loss(model(torch.from_numpy(run["images"])), targets), "cos_l1")
    names = [n for n, _ in model.named_parameters()]
    found = torch.autograd.grad(loss, [p for _, p in model.named_parameters()], allow_unused=True)
    want = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                      for (_, p), g in zip(model.named_parameters(), found)])
    reduced = run["ranks"][0]["float32"]["reduced"]
    assert list(reduced) == names
    got = torch.cat([reduced[n].reshape(-1) for n in names])
    assert _rel_l2(got.numpy(), want.numpy()) < 1e-5


@pytest.mark.parametrize("wire", list(WIRES))
def test_one_gradient_all_reduce_and_one_metrics_all_reduce_a_step(run, wire):
    got = run["ranks"][0][wire]
    n_params = sum(p.numel() for p in got["params"].values())
    n_metrics = 4 + 3 * len(TARGETS)  # loss, 3 terms, 3 per-teacher terms a teacher
    assert got["calls"] == [(n_params, f"torch.{wire}"), (n_metrics, "torch.float32")] * STEPS


def _jax_batches(cfg, split, rank, seed, drop_last=False):
    ds, n = jds.get_image_video_dataset(
        dataset_root=cfg.dataset.dataset_root, dataset_mix=list(cfg.dataset.dataset_mix), feature_models=list(TEACHER),
        feature_norm=cfg.dataset.feature_norm, stats_root=cfg.dataset.get("stats_root"), rank=rank, world_size=2,
        seed=cfg.seed, split=split, dataset_ratio=cfg.dataset.dataset_ratio if split == "train" else 0.1,
        shuffle=cfg.dataset.shuffle if split == "train" else False)
    train = split == "train"
    loader = jds.get_frame_dataloader(ds, batch_size=int(cfg.training.batch_size), shuffle=train and cfg.dataset.shuffle,
                                      shuffle_buffer_size=cfg.dataset.shuffle_buffer_size, seed=seed,
                                      drop_last=drop_last)
    return [b["image"] for b in loader], n


def test_loop_ranks_read_the_jax_data_functions_batches(run):
    """Each rank's train batches are the JAX loader's for (rank, world 2) at
    the seed cfg.seed + rank*100 + epoch; its eval batch the JAX eval
    loader's with drop_last."""
    cfg = jload_config("train_rvfm_imagenet", _overrides(run["root"], run["tmp"]))
    for rank, rec in enumerate(r["loop"] for r in run["ranks"]):
        want = []
        for ep in (0, 1):
            batches, _ = _jax_batches(cfg, "train", rank, cfg.seed + rank * 100 + ep)
            want += batches[:2]
        assert len(rec["train"]) == len(want) == 4
        assert all(np.array_equal(g.numpy(), w) for g, w in zip(rec["train"], want))
        evals, _ = _jax_batches(cfg, "val", rank, cfg.seed, drop_last=True)
        assert len(rec["eval"]) == 2 and all(np.array_equal(g.numpy(), evals[0]) for g in rec["eval"])
    assert not np.array_equal(run["ranks"][0]["loop"]["train"][0], run["ranks"][1]["loop"]["train"][0])


def test_loop_step_counts_and_lr_follow_the_jax_arithmetic_at_two_processes(run):
    cfg = jload_config("train_rvfm_imagenet", _overrides(run["root"], run["tmp"]))
    _, train_len = _jax_batches(cfg, "train", 0, cfg.seed)
    _, eval_len = _jax_batches(cfg, "val", 0, cfg.seed)
    bs = int(cfg.training.batch_size)
    epoch_steps = -(-train_len // (bs * 2))  # ceil(train_len / batch / n_data)
    assert epoch_steps == 2 and max(eval_len // (bs * 2), 1) == 1
    assert [r["loop"]["steps"] for r in run["ranks"]] == [[2, 4]] * 2
    lr = joptim.scaled_lr(float(cfg.training.base_lr), bs, 2, int(cfg.training.base_batch_size),
                          int(cfg.training.base_world_size))
    (log,) = Path(run["tmp"], "logs").glob("*.metrics.jsonl")
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    got = {r["step"]: r["lr"] for r in rows if "lr" in r}
    for epochs, steps in ((1, (1, 2)), (2, (3, 4))):
        total = epoch_steps * epochs
        schedule = jloop.build_lr_schedule(cfg, lr, total, int(cfg.training.warm_up_steps_ratio * total))
        for s in steps:
            np.testing.assert_allclose(got[s], float(schedule(s)), rtol=1e-6)


def test_loop_ranks_end_bit_equal_with_one_set_of_checkpoints(run):
    a, b = (r["loop"] for r in run["ranks"])
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    assert a["evals"] == b["evals"] and a["evals"][0]["avg_eval_cos_loss"] > 0
    assert a["timing"] == [True, True] and b["timing"] == [False, False]  # rank 0 keeps the timing
    (ckpt_dir,) = Path(run["tmp"], "ckpt").iterdir()
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "4.pt"]
    saved = tckpt.read_params(str(ckpt_dir))
    assert saved[0] == 4 and all(torch.equal(saved[1][n], a["params"][n]) for n in a["params"])


def test_world_size_without_the_torchrun_environment_raises(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    for k in ("RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(ValueError, match="torchrun"):
        pdist.init_distributed("cpu")
    assert pdist.world_size() == 1 and pdist.rank() == 0
