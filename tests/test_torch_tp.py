"""Tensor parallelism of the port over gloo processes on the CPU
(``parallel/mesh.py``, ``parallel/tp.py``, the split LayerNormSpatial and
loss, the step's grid buckets, ``train_from_config`` at ``model_axis=2``),
against the JAX package's tensor-parallel step on a (1, 2) mesh of CPU
devices, its ``tp_specs`` and its LayerNormSpatial.

Processes (``tests/torch_tp_worker.py``, one intra-op thread each) are
started once a grid: two ranks at ``model_axis=2`` (TP(2)) and four at
``model_axis=2`` (a 2 x 2 data x model grid). The model is a 2-layer
deit-small Theia (6 heads) with an lconv 16x16 head (through the pad
pre-conv), a 7x7 head (row-parallel last Dense), and two ``_cls`` heads,
in float32 exact mode; a global batch of 4, two steps with the grad clip.

Tolerances: the JAX test's own (tests/test_tensor_parallel.py: losses rtol
2e-5, parameters atol 3e-4 after two float32 steps) against the JAX TP
step and against the port at one process on the whole batch; the DP
test's bounds against JAX (tests/test_torch_distributed.py: parameter
changes within relative L2 0.1, moments 0.05).
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

from theia_tpu.data.synthetic import generate_synthetic_dataset
from theia_tpu.models import layers as jlayers
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.parallel.mesh import make_mesh, shard_batch
from theia_tpu.parallel.tp import tp_specs, train_state_shardings, validate_tp as jvalidate_tp
from theia_tpu.train import optim as joptim
from theia_tpu.train.state import TrainState as JTrainState
from theia_tpu.train.step import make_train_step as jmake_train_step
from theia_tpu_torch.models import losses as tlosses
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.pretrained import load_theia_checkpoint
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.parallel import tp as ttp
from theia_tpu_torch.parallel.mesh import Grid, make_grid
from theia_tpu_torch.train import optim as toptim
from theia_tpu_torch.train import step as tstep
from theia_tpu_torch.train.state import TrainState

SMALL = "facebook/deit-small-patch16-224"
TARGETS = {"teacher/a": (64, 16, 16), "teacher/c": (32, 7, 7), "teacher/a_cls": (1024,), "teacher/b_cls": (48,)}
TEACHER = {"facebook/dinov2-large": (1024, 16, 16)}
BATCH, STEPS, LR, CLIP = 4, 2, 1e-3, 0.5
REPO = Path(__file__).resolve().parent.parent
EXACT = ["training.compute_dtype=float32", "training.fast_math=false", "training.fuse_preprocessing=false",
         "training.moment_dtype=float32"]
GRIDS = {"tp2": 2, "data2_model2": 4}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _noise_only(name):
    return name.endswith("attention.attention.key.bias")


def _targets(rng, sizes, b):
    return {t: rng.standard_normal((b, s[0]) if len(s) == 1 else (b, s[1] * s[2], s[0]), dtype=np.float32)
            for t, s in sizes.items()}


def _save_batch(path, images, targets):
    names = {f"target{i}": t for i, t in enumerate(targets)}
    np.savez(path, images=images, **{k: targets[t] for k, t in names.items()})
    return names


def _launch(spec_path, world):
    port = _free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen([sys.executable, str(REPO / "tests" / "torch_tp_worker.py"), str(spec_path)],
                                      env=env, cwd=str(spec_path.parent), stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    return procs


def _collect(procs, out_dir):
    outs = [p.communicate(timeout=400)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(len(procs))]


def _jax_tp_steps(params, images, targets):
    """The JAX package's TP step on a (1, 2) mesh: two steps, grad clip on."""
    jmodel = JTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TARGETS)
    jtx = joptim.make_optimizer(joptim.constant_with_warmup(LR, 10), weight_decay=0.01)
    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    jvalidate_tp(6, 1536, 2)
    state_sh = train_state_shardings(mesh, jtx, params, tp_specs(params, 2))
    step = jmake_train_step(jmodel, jtx, main_loss="cos_l1", mesh=mesh, state_shardings=state_sh, donate=False,
                            grad_clip=True, grad_clip_norm=CLIP)
    state = JTrainState.create(params, jtx)
    batch = shard_batch(mesh, (jnp.asarray(images), {t: jnp.asarray(v) for t, v in targets.items()}))
    losses = []
    for _ in range(STEPS):
        state, m = step(state, *batch)
        losses.append(float(m["loss"]))
    return jax.device_get(state), losses


def _port_steps(sd, images, targets, steps, **kw):
    """The port at one process on the whole batch."""
    model = TTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TARGETS, **kw)
    model.load_state_dict(sd, strict=True)
    tx = toptim.make_optimizer(toptim.constant_with_warmup(LR, 10), weight_decay=0.01,
                               moment_dtype=torch.bfloat16 if kw.get("fast_math") else None)
    step = tstep.make_train_step(model, tx, grad_clip=True, grad_clip_norm=CLIP)
    state = TrainState.create(dict(model.named_parameters()), tx)
    images = torch.from_numpy(images)
    targets = {t: torch.from_numpy(v) for t, v in targets.items()}
    losses = []
    for _ in range(steps):
        state, m = step(state, images, targets)
        losses.append(float(m["loss"]))
    return losses, {n: p.detach().clone() for n, p in state.params.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Every grid's records, the JAX TP trajectory, the port's one-process ones, the inputs."""
    saved = [(configs, configs[SMALL]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[SMALL] = dataclasses.replace(cfg, num_layers=2)
    try:
        tmp = tmp_path_factory.mktemp("tp")
        jmodel = JTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TARGETS)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
        sd = state_dict_from_jax(params, TARGETS)
        torch.save(sd, tmp / "sd.pt")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
        targets = _targets(rng, TARGETS, BATCH)
        names = _save_batch(tmp / "batch.npz", images, targets)
        np.savez(tmp / "ln.npz", **{k: rng.standard_normal(s, dtype=np.float32) for k, s in
                                    (("x", (2, 8, 5, 5)), ("w", (8, 5, 5)), ("b", (8, 5, 5)), ("g", (2, 8, 5, 5)))})
        np.savez(tmp / "loss.npz", **{f"{key}_{k}": rng.standard_normal(s, dtype=np.float32)
                                      for key, s in (("wide", (2, 16, 128)), ("narrow", (2, 48)))
                                      for k in ("pred", "target")})
        root = tmp / "shards"
        generate_synthetic_dataset(str(root), feature_models=TEACHER, n_train=4, n_val=4, samples_per_shard=2)
        overrides = ["model/backbone=deit", "training/target_models=dinov2", f"dataset.dataset_root={root}",
                     "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=4", "training.batch_size=2",
                     "training.model_axis=2", f"logging.model_path={tmp}/ckpt", f"logging.log_path={tmp}/logs",
                     "logging.save_ckpt_interval=0", "logging.log_interval=1", *EXACT]
        common = dict(state_dict=str(tmp / "sd.pt"), batch=str(tmp / "batch.npz"), names=names,
                      targets=TARGETS, n_model=2, steps=STEPS, lr=LR, clip=CLIP)
        procs = {}
        for grid, world in GRIDS.items():
            (tmp / grid).mkdir()
            cases = ["tp_steps"]
            if grid == "tp2":
                cases = ["tp_steps", "tp_recipe", "ln", "loss", "loop"]
            spec = dict(common, world=world, cases=cases, out=str(tmp / grid), ln=str(tmp / "ln.npz"),
                        loss=str(tmp / "loss.npz"), overrides=overrides)
            (tmp / grid / "spec.json").write_text(json.dumps(spec))
            procs[grid] = _launch(tmp / grid / "spec.json", world)
        jstate, jlosses = _jax_tp_steps(params, images, targets)
        one = _port_steps(sd, images, targets, STEPS)
        recipe = _port_steps(sd, images, targets, 1, dtype=torch.bfloat16, fast_math=True, fuse_preprocessing=True)
        grids = {grid: _collect(p, tmp / grid) for grid, p in procs.items()}
        yield dict(grids=grids, jax=(jstate, jlosses), one=one, recipe=recipe, params=params, sd=sd, tmp=tmp)
    finally:
        for configs, cfg in saved:
            configs[SMALL] = cfg


def _sd(tree):
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, TARGETS).items()}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_steps_match_the_jax_tp_step(run, grid):
    jstate, jlosses = run["jax"]
    got = run["grids"][grid][0]["tp"]
    np.testing.assert_allclose(got["losses"], jlosses, rtol=2e-5)
    init, want = _sd(run["params"]), _sd(jstate.params)
    for n, w in want.items():
        np.testing.assert_allclose(got["params"][n].numpy(), w, atol=3e-4, err_msg=n)
        if not (_noise_only(n) or np.array_equal(w, init[n])):
            assert _rel_l2(got["params"][n].numpy() - init[n], w - init[n]) < 0.1, n
    for moments, jm in ((got["mu"], jstate.opt_state.mu), (got["nu"], jstate.opt_state.nu)):
        for n, w in _sd(jm).items():
            if not (_noise_only(n) or not w.any()):
                assert _rel_l2(moments[n].float().numpy(), w) < 0.05, n
    assert set(got["count"].values()) == {STEPS}


@pytest.mark.parametrize("grid", list(GRIDS))
def test_tp_steps_match_one_process(run, grid):
    losses, params = run["one"]
    got = run["grids"][grid][0]["tp"]
    np.testing.assert_allclose(got["losses"], losses, rtol=2e-5)
    for n, p in params.items():
        np.testing.assert_allclose(got["params"][n].numpy(), p.numpy(), atol=3e-4, err_msg=n)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_ranks_hold_their_slices_and_agree(run, grid):
    """Every split parameter is halved on its plan's dimension; every rank
    ends with the same whole parameters, and the replicated ones are bit-equal
    across the grid; losses and clip norms agree."""
    records = run["grids"][grid]
    a = records[0]["tp"]
    assert [r["grid"] for r in records] == [(GRIDS[grid] // 2, 2, r // 2, r % 2) for r in range(GRIDS[grid])]
    whole = {n: tuple(p.shape) for n, p in a["params"].items()}
    assert len(a["split"]) > 0
    for n, shape in a["local_shapes"].items():
        if n in a["split"]:
            assert sum(x != y for x, y in zip(shape, whole[n])) == 1 and np.prod(shape) * 2 == np.prod(whole[n]), n
        else:
            assert shape == whole[n], n
    assert a["split_outputs"] == {"teacher/a": True, "teacher/c": False, "teacher/a_cls": True,
                                  "teacher/b_cls": True}
    for b in (r["tp"] for r in records[1:]):
        assert b["losses"] == a["losses"] and b["grad_norms"] == a["grad_norms"]
        for n in a["params"]:
            assert torch.equal(a["params"][n], b["params"][n]), n


def test_tp_recipe_step_tracks_one_process(run):
    """bf16 compute, fast_math and fused preprocessing under TP(2): the
    step's loss against one process's (the recipe's tolerance, rtol 2e-2)."""
    got = run["grids"]["tp2"][0]["tp_recipe"]
    np.testing.assert_allclose(got["losses"], run["recipe"][0], rtol=2e-2)
    assert np.isfinite(got["grad_norms"]).all()


@pytest.mark.parametrize("impl", ["pallas", "vpu"])
def test_split_layer_norm_matches_the_jax_vjp(run, impl, monkeypatch):
    """LayerNormSpatial on a map split on C over 2 ranks (K3 -> all-reduce of
    s1, s2 -> K4 with the whole sample's N, on their plain versions; and
    autograd of the plain forward with its sums summed both ways) against
    the JAX module's forward and VJP on the whole map."""
    monkeypatch.setattr(jlayers, "LN_STATS_IMPL", "vpu")
    arrays = np.load(run["tmp"] / "ln.npz")
    x, w, b, g = (arrays[k] for k in ("x", "w", "b", "g"))
    mod = jlayers.LayerNormSpatial(shape_chw=w.shape)
    nhwc = lambda a: jnp.asarray(a.transpose(0, 2, 3, 1))  # noqa: E731
    y, vjp = jax.vjp(lambda p, xx: mod.apply({"params": p}, xx),
                     {"weight": jnp.asarray(w), "bias": jnp.asarray(b)}, nhwc(x))
    dp, dx = vjp(nhwc(g))
    got = run["grids"]["tp2"][0]["ln"][impl]
    np.testing.assert_allclose(got["y"].numpy(), np.asarray(y).transpose(0, 3, 1, 2), atol=1e-5)
    np.testing.assert_allclose(got["dx"].numpy(), np.asarray(dx).transpose(0, 3, 1, 2), atol=1e-5)
    np.testing.assert_allclose(got["dw"].numpy(), np.asarray(dp["weight"]), atol=1e-5)
    np.testing.assert_allclose(got["db"].numpy(), np.asarray(dp["bias"]), atol=1e-5)


@pytest.mark.parametrize("key", ["wide", "narrow"])
def test_split_loss_matches_the_unsplit_loss(run, key):
    """The loss of features split over 2 ranks (fused: K5's sums all-reduced,
    means over the whole D; unfused: the prediction gathered) and its
    gradient, against one process's on the whole features."""
    arrays = np.load(run["tmp"] / "loss.npz")
    pred = torch.from_numpy(arrays[f"{key}_pred"]).requires_grad_(True)
    losses = tlosses.get_loss({"t": pred}, {"t": torch.from_numpy(arrays[f"{key}_target"])})
    tlosses.main_loss_from_terms(losses, "cos_l1").backward()
    got = run["grids"]["tp2"][0]["loss"][key]
    np.testing.assert_allclose(got["terms"], [losses[k].item() for k in ("mse_loss", "l1_loss", "cos_loss")],
                               rtol=1e-6)
    np.testing.assert_allclose(got["grad"].numpy(), pred.grad.numpy(), rtol=1e-5, atol=1e-9)


def test_train_from_config_at_model_axis_2_saves_and_resumes(run):
    """Two ranks of one data index read the same rows; one epoch, then a
    resume for a second; rank 0's checkpoint is in the whole layout and
    loads with ``load_theia_checkpoint`` at one process."""
    a, b = (r["loop"] for r in run["grids"]["tp2"])
    assert a["steps"] == b["steps"] == [2, 4]
    assert len(a["train"]) == 4 and all(torch.equal(x, y) for x, y in zip(a["train"], b["train"]))
    assert a["losses"] == b["losses"] and all(np.isfinite(a["losses"]))
    ckpt_dir = Path(a["ckpt_dir"])
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "4.pt"]
    saved = torch.load(ckpt_dir / "4.pt", weights_only=True)
    model = TTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TEACHER)
    assert {n: tuple(p.shape) for n, p in saved["params"].items()} == {
        n: tuple(p.shape) for n, p in model.named_parameters()}
    assert all(saved["mu"][n].shape == p.shape for n, p in model.named_parameters())
    load_theia_checkpoint(str(ckpt_dir), model)
    assert all(torch.equal(p, saved["params"][n]) for n, p in model.named_parameters())


@pytest.fixture()
def small_backbone():
    saved = [(configs, configs[SMALL]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[SMALL] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, cfg in saved:
        configs[SMALL] = cfg


TRANSLATOR_KWARGS = {"lconv": {}, "mlp": dict(translator_hidden_size=32, translator_n_layer=3),
                     "conv": dict(translator_hidden_size=8)}
PLAN_TARGETS = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64)}


@pytest.mark.parametrize("translator", list(TRANSLATOR_KWARGS))
def test_plan_matches_jax_tp_specs(translator, small_backbone):
    """``tp_plan`` against the JAX ``tp_specs`` leaf by leaf: each JAX leaf
    holds its index along the "model" axis (zeros where replicated), carried
    through ``state_dict_from_jax``; the port's split dimension is where the
    carried leaf varies."""
    sizes = dict(PLAN_TARGETS)
    if translator == "lconv":
        sizes.update({"teacher/c": (8, 7, 7), "teacher/a_cls": (24,)})
    kw = TRANSLATOR_KWARGS[translator]
    jparams = JTheia(backbone=SMALL, translator=translator, target_feature_sizes=sizes,
                     translator_kwargs=kw).init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
    specs = tp_specs(jparams, 2)

    def marked(leaf, spec):
        axes = [i for i, a in enumerate(tuple(spec)) if a == "model"]
        shape = np.shape(leaf)
        return np.broadcast_to(np.arange(shape[axes[0]]).reshape(
            [-1 if i == axes[0] else 1 for i in range(len(shape))]), shape).astype(np.float32) if axes else \
            np.zeros(shape, np.float32)

    tree = jax.tree.map(marked, jparams, specs, is_leaf=lambda x: hasattr(x, "shape"))
    carried = state_dict_from_jax(tree, sizes, translator=translator)
    model = TTheia(backbone=SMALL, translator=translator, target_feature_sizes=sizes, translator_kwargs=kw)
    plan = ttp.tp_plan(model, 2)
    assert set(plan.dims) == set(carried)
    for n, t in carried.items():
        varies = [d for d in range(t.dim()) if t.shape[d] > 1 and bool((t.diff(dim=d) != 0).any())]
        assert plan.dims[n] == (varies[0] if varies else None), n
        assert len(varies) <= 1, n
    assert any(d is not None for n, d in plan.dims.items() if n.startswith("translator."))


def test_indivisible_head_stays_replicated_with_a_warning(small_backbone):
    model = TTheia(backbone=SMALL, translator="lconv", target_feature_sizes={"x/odd": (30, 16, 16)})
    with pytest.warns(UserWarning, match="replicating this head"):
        plan = ttp.tp_plan(model, 4)
    assert all(d is None for n, d in plan.dims.items() if n.startswith("translator."))
    assert any(d is not None for n, d in plan.dims.items() if n.startswith("backbone."))


def test_validate_tp_and_the_grid_reject_indivisible_axes():
    with pytest.raises(ValueError, match="must divide"):
        ttp.validate_tp(3, 768, 2)
    ttp.validate_tp(6, 1536, 2)
    with pytest.raises(ValueError, match="must divide the world"):
        make_grid(2)  # one process
    assert make_grid(1) == Grid(1, 1, 0, 0)


@pytest.mark.parametrize("translator", ["mlp", "conv"])
def test_other_translators_refuse_the_cut(translator, small_backbone):
    model = TTheia(backbone=SMALL, translator=translator, target_feature_sizes=PLAN_TARGETS,
                   translator_kwargs=TRANSLATOR_KWARGS[translator])
    with pytest.raises(NotImplementedError, match="lconv"):
        ttp.shard_module(model, Grid(1, 2, 0, 0))
