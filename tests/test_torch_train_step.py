"""The port's distillation train step against the JAX package's, on the 2-layer
deit-tiny Theia of tests/test_train_step.py, from the same parameters and
the same batch (images and raw [B, C, H, W] targets made with numpy).

Tolerances, float32 (attention and LayerNormSpatial through the port's
autograd functions, whose CPU backward is the plain version):
  - loss of each step: rtol 1e-5;
  - gradients of one step: relative L2 5e-3 per tensor (the same math with
    sums in another order; the ReLUs of the 16 -> 64 ladder flip where a
    pre-activation is within rounding of 0, which moves ~1e-3 of a
    gradient's norm, and a few preprocessed pixels round one uint8 step
    apart, see tests/test_torch_theia.py, which moves the patch embedding's);
  - parameters after 3 AdamW steps: the change from the start within
    relative L2 0.1 of JAX's change, per tensor; moments within 0.05.
    Adam divides each gradient by its own running magnitude, which turns
    those flips into differences of a few percent of an update;
  - per-parameter step counts: exact; a masked or frozen parameter: bit for
    bit unchanged.
The key biases get no gradient in exact arithmetic (softmax ignores a
constant added to a row's scores), so Adam moves them by rounding noise
alone; they are left out of the relative comparisons.
bf16 compute (float32 params): losses within rtol 2e-2 (bf16 rounds at
other places in XLA and in PyTorch).
The port's loss is the fused one (``FUSED_LOSS``) for both teachers here;
the JAX step's is its unfused default: the same sums in another order. The
production recipe (``fast_math``, ``fuse_preprocessing``, bf16 moments)
is held to the same tolerances.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.train import optim as joptim
from theia_tpu.train.state import TrainState as JTrainState
from theia_tpu.train.step import make_eval_step as jmake_eval_step
from theia_tpu.train.step import make_train_step as jmake_train_step
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.train import optim as toptim
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_eval_step, make_train_step

TINY = "facebook/deit-tiny-patch16-224"
TARGETS = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64)}
STEPS = 3
LR = 1e-4


@pytest.fixture(scope="module", autouse=True)
def two_layer_backbones():
    saved = [(configs, configs[TINY]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[TINY] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, cfg in saved:
        configs[TINY] = cfg


@pytest.fixture(scope="module")
def jax_params():
    model = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)
    return model.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    imgs = rng.integers(0, 256, (b, 224, 224, 3), dtype=np.uint8)
    targets = {t: rng.standard_normal((b, c, h, w), dtype=np.float32) for t, (c, h, w) in TARGETS.items()}
    return imgs, targets


def _port_model(params, dtype=torch.float32, **model_kw):
    model = TTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS, dtype=dtype, **model_kw)
    model.load_state_dict(state_dict_from_jax(params, TARGETS), strict=True)
    return model


def _sd(tree):
    """A tree of the params' structure (params, grads, moments) in the port's names, as float32."""
    tree = jax.tree.map(lambda x: np.asarray(x, np.float32), tree)
    return {k: v.numpy() for k, v in state_dict_from_jax(tree, TARGETS).items()}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30))


def _noise_only(name):
    return name.endswith("attention.attention.key.bias")


def _counts(count_tree, params):
    """Per-leaf int counts mapped to the port's names (broadcast, then read back)."""
    full = jax.tree.map(lambda c, p: np.full(p.shape, int(c), np.float32), count_tree, params)
    return {k: int(v.reshape(-1)[0]) for k, v in _sd(full).items()}


CASES = {
    "f32": (dict(), dict(), None),
    "clip_warmup": (dict(schedule=2), dict(grad_clip=True, warmup_steps=2), None),
    "loss_masks": (dict(), dict(), {"teacher/a": 1.0, "teacher/b": 0.0}),
    "freeze_translator": (dict(), dict(freeze_translator=True, freeze_translator_start_step=1), None),
    "bf16_moments_lr_factor": (dict(moment_dtype="bf16", translator_lr_factor=0.5), dict(), None),
    "bf16_moments": (dict(moment_dtype="bf16"), dict(), None),  # the recipe's optimizer
}


def _optimizers(opt):
    lr_j, lr_t = LR, LR
    if "schedule" in opt:
        lr_j = joptim.constant_with_warmup(LR, opt["schedule"])
        lr_t = toptim.constant_with_warmup(LR, opt["schedule"])
    kw = dict(weight_decay=0.01, translator_lr_factor=opt.get("translator_lr_factor", 1.0))
    bf16 = opt.get("moment_dtype") == "bf16"
    jtx = joptim.make_optimizer(lr_j, moment_dtype=jnp.bfloat16 if bf16 else None, **kw)
    ttx = toptim.make_optimizer(lr_t, moment_dtype=torch.bfloat16 if bf16 else None, **kw)
    return jtx, ttx


RECIPE = dict(fast_math=True, fuse_preprocessing=True)


def _run_both(params, case, dtype=(jnp.float32, torch.float32), model_kw=None):
    opt, step_kw, masks = CASES[case]
    model_kw = model_kw or {}
    jtx, ttx = _optimizers(opt)
    imgs, targets = _batch()
    jmodel = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS, dtype=dtype[0], **model_kw)
    jstep = jmake_train_step(jmodel, jtx, donate=False, **step_kw)
    jstate = JTrainState.create(params, jtx)
    jmasks = None if masks is None else {t: jnp.asarray(m) for t, m in masks.items()}
    jlosses = []
    for _ in range(STEPS):
        jstate, m = jstep(jstate, jnp.asarray(imgs), {t: jnp.asarray(v) for t, v in targets.items()}, jmasks)
        jlosses.append(float(m["loss"]))

    model = _port_model(params, dtype[1], **model_kw)
    step = make_train_step(model, ttx, **step_kw)
    state = TrainState.create(dict(model.named_parameters()), ttx)
    timgs, ttargets = torch.from_numpy(imgs), {t: torch.from_numpy(v) for t, v in targets.items()}
    losses = []
    for _ in range(STEPS):
        state, m = step(state, timgs, ttargets, masks)
        losses.append(float(m["loss"]))
    return jstate, jlosses, model, state, losses


def test_grads_match_jax(jax_params):
    """One step's gradients: the JAX loss's jax.grad against the port's
    autograd, mapped into the port's names by ``state_dict_from_jax``."""
    from theia_tpu.models.losses import get_loss as jget_loss, main_loss_from_terms as jmain
    from theia_tpu.train.step import prepare_targets as jprep
    from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
    from theia_tpu_torch.train.step import prepare_targets

    imgs, targets = _batch(seed=1)
    jmodel = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)

    def loss_fn(p):
        preds = jmodel.apply({"params": p}, jnp.asarray(imgs))
        return jmain(jget_loss(preds, jprep({t: jnp.asarray(v) for t, v in targets.items()})), "cos_l1")

    jloss, jgrads = jax.value_and_grad(loss_fn)(jax_params)
    model = _port_model(jax_params)
    tt = prepare_targets({t: torch.from_numpy(v) for t, v in targets.items()})
    loss = main_loss_from_terms(get_loss(model(torch.from_numpy(imgs)), tt), "cos_l1")
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    want = _sd(jgrads)
    got = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(got) == set(want)
    for n, w in want.items():
        if not _noise_only(n):
            assert _rel_l2(got[n], w) < 5e-3, n


@pytest.mark.parametrize("case", list(CASES))
def test_train_steps_match_jax(jax_params, case):
    _check_trajectory(jax_params, case, *_run_both(jax_params, case))


def _check_trajectory(jax_params, case, jstate, jlosses, model, state, losses):
    """Losses, parameter changes, moments and step counts of the two steps."""
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    init, want = _sd(jax_params), _sd(jstate.params)
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    moment_dtype = torch.bfloat16 if case.startswith("bf16") else torch.float32
    for n, w in want.items():
        assert state.opt_state.mu[n].dtype == state.opt_state.nu[n].dtype == moment_dtype
        if _noise_only(n) or np.array_equal(w, init[n]):
            continue
        assert _rel_l2(got[n] - init[n], w - init[n]) < 0.1, n
    for moments, jm in ((state.opt_state.mu, jstate.opt_state.mu), (state.opt_state.nu, jstate.opt_state.nu)):
        for n, w in _sd(jm).items():
            if not (_noise_only(n) or not w.any()):
                assert _rel_l2(moments[n].float().numpy(), w) < 0.05, n
    counts = _counts(jstate.opt_state.count, jstate.params)
    assert {n: int(c) for n, c in state.opt_state.count.items()} == counts
    assert int(state.step) == int(jstate.step) == STEPS
    assert int(state.opt_state.sched_count) == STEPS

    head_b = [n for n in got if n.startswith("translator.translator_heads.teacher/b.")]
    assert head_b
    if case == "loss_masks":  # the masked head: params, moments and counts untouched
        for n in head_b:
            np.testing.assert_array_equal(got[n], init[n])
            np.testing.assert_array_equal(want[n], init[n])
            assert float(state.opt_state.mu[n].abs().max()) == float(state.opt_state.nu[n].abs().max()) == 0.0
            assert counts[n] == 0
    if case == "freeze_translator":  # the translator moves at step 0 only
        assert all(counts[n] == (1 if n.startswith("translator.") else STEPS) for n in got)


def test_flash_attention_train_steps_match_jax(jax_params, monkeypatch):
    """The exact-mode step with attention_impl="flash" (FlashFunction, its
    CPU forward and backward the plain flash versions) against the JAX step
    (einsum attention off the TPU)."""
    monkeypatch.setitem(tvit.BACKBONE_CONFIGS, TINY, dataclasses.replace(tvit.BACKBONE_CONFIGS[TINY],
                                                                         attention_impl="flash"))
    jstate, jlosses, model, state, losses = _run_both(jax_params, "f32")
    assert model.backbone.cfg.attention_impl == "flash"
    _check_trajectory(jax_params, "f32", jstate, jlosses, model, state, losses)


def test_recipe_train_steps_match_jax(jax_params):
    """The production recipe's step in float32 compute: fast_math,
    fuse_preprocessing, the fused loss, bf16 moments."""
    _check_trajectory(jax_params, "bf16_moments", *_run_both(jax_params, "bf16_moments", model_kw=RECIPE))


def test_recipe_bf16_compute_tracks_jax(jax_params):
    """The production recipe as it trains: bf16 compute over float32 params."""
    _, jlosses, model, state, losses = _run_both(jax_params, "bf16_moments", (jnp.bfloat16, torch.bfloat16),
                                                 model_kw=RECIPE)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert all(m.dtype == torch.bfloat16 for m in state.opt_state.mu.values())
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert losses[-1] < losses[0]


def test_bf16_compute_tracks_jax(jax_params):
    """bf16 compute over float32 params, on both sides: the losses track."""
    _, jlosses, model, state, losses = _run_both(jax_params, "f32", (jnp.bfloat16, torch.bfloat16))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    np.testing.assert_allclose(losses, jlosses, rtol=2e-2)
    assert losses[-1] < losses[0]


def test_eval_step_matches_jax(jax_params):
    imgs, targets = _batch(seed=2)
    jmodel = JTheia(backbone=TINY, translator="lconv", target_feature_sizes=TARGETS)
    want = jmake_eval_step(jmodel)(jax_params, jnp.asarray(imgs), {t: jnp.asarray(v) for t, v in targets.items()})
    got = make_eval_step(_port_model(jax_params))(
        torch.from_numpy(imgs), {t: torch.from_numpy(v) for t, v in targets.items()}
    )
    for k in ("loss", "mse_loss", "cos_loss", "l1_loss"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    for t in TARGETS:
        np.testing.assert_allclose(float(got["cos_losses_per_model"][t]), float(want["cos_losses_per_model"][t]),
                                   rtol=1e-5)
