"""Training the port's mlp, conv and transformer translators against the JAX package.

The transformer's train step with a teacher masked follows the JAX leaf
rule (``theia_tpu/train/step.py:219-245``): losses rtol 1e-5, the masked
head bit for bit unchanged. 3 steps of ``train_from_config`` for each
translator: losses within rtol 1e-5 of the JAX loop's in exact mode and
2e-2 at the recipe (tests/test_torch_runtime.py's tolerances, on its
shards). Widths are cut (2-layer deit-tiny, translator hidden 8-32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.config import load_config as jload_config
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.parallel import mesh as jmesh
from theia_tpu.train import loop as jloop
from theia_tpu.train import optim as joptim
from theia_tpu.train.state import TrainState as JTrainState
from theia_tpu.train.step import make_train_step as jmake_train_step
from theia_tpu_torch.config import load_config
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.train import checkpoint as tckpt
from theia_tpu_torch.train import loop as tloop
from theia_tpu_torch.train import optim as toptim
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_train_step
from test_torch_runtime import EXACT, _losses, _overrides, shards  # noqa: F401 (the shards fixture)
from test_torch_translators import (  # noqa: F401 (the module's fixtures)
    KWARGS, TARGETS, TINY, TRANSLATORS, _jax_params, _jax_theia, _port_theia, one_torch_thread, two_layer_backbones,
)


def test_transformer_step_masks_match_jax():
    """3 train steps of the transformer translator from the same params, one
    teacher masked, translator LR factor 0.5: losses rtol 1e-5; the masked
    teacher's head and its moments bit for bit unchanged, its
    ``target_model_emb`` updated as the JAX step updates it (no teacher
    mask: its gradient is 0, so weight decay alone moves it); the stem, the
    decode tokens and the backbone adapter as JAX's."""
    sizes = TARGETS
    params = _jax_params("transformer", sizes)
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    targets = {t: rng.standard_normal((2, c, h, w), dtype=np.float32) for t, (c, h, w) in sizes.items()}
    masks = {"teacher/a": 1.0, "teacher/b": 0.0}
    step_kw, factor = {}, 0.5
    jtx = joptim.make_optimizer(1e-3, weight_decay=0.01, translator_lr_factor=factor)
    ttx = toptim.make_optimizer(1e-3, weight_decay=0.01, translator_lr_factor=factor)

    jstep = jmake_train_step(_jax_theia("transformer", sizes), jtx, donate=False, **step_kw)
    jstate = JTrainState.create(params, jtx)
    jlosses = []
    for _ in range(3):
        jstate, m = jstep(jstate, jnp.asarray(imgs), {t: jnp.asarray(v) for t, v in targets.items()},
                          {t: jnp.asarray(v) for t, v in masks.items()})
        jlosses.append(float(m["loss"]))

    model = _port_theia("transformer", sizes)
    model.load_state_dict(state_dict_from_jax(params, sizes, translator="transformer"), strict=True)
    state = TrainState.create(dict(model.named_parameters()), ttx)
    init = {n: p.detach().clone() for n, p in model.named_parameters()}
    step = make_train_step(model, ttx, **step_kw)
    losses = []
    for _ in range(3):
        state, m = step(state, torch.from_numpy(imgs), {t: torch.from_numpy(v) for t, v in targets.items()}, masks)
        losses.append(float(m["loss"]))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)

    want = {k: v.numpy() for k, v in state_dict_from_jax(jax.tree.map(np.asarray, jstate.params), sizes,
                                                         translator="transformer").items()}
    got = {n: p.detach().numpy() for n, p in model.named_parameters()}
    emb_b, head_b = "translator.target_model_emb.teacher/b", "translator.translator_heads.teacher/b."
    stem = "translator.translator_stem.layers.0.linear1.weight"
    for n in (emb_b, stem, "translator.decode_tokens", "translator.backbone_adapter.1.weight"):
        moved = want[n] - init[n].numpy()
        if not moved.any():
            assert np.array_equal(got[n], want[n]), n
            continue
        assert np.linalg.norm((got[n] - init[n].numpy()) - moved) < 0.1 * np.linalg.norm(moved), n
    for n, p in model.named_parameters():
        if n.startswith(head_b):
            assert torch.equal(p, init[n]) and not state.opt_state.mu[n].any(), n
            assert int(state.opt_state.count[n]) == 0
    assert int(state.opt_state.count[emb_b]) == 3
    # weight decay alone, at the translator's LR: p (1 - 0.5 lr·wd)^3 in both
    np.testing.assert_allclose(got[emb_b], init[emb_b].numpy() * (1 - 0.5 * 1e-3 * 0.01) ** 3, rtol=1e-6)


def _loop_overrides(root, out, t, extra=()):
    hidden = KWARGS[t]["translator_hidden_size"]
    return _overrides(root, out, [f"model/translator={t}", f"model.translator.kwargs.translator_hidden_size={hidden}",
                                  *extra])


@pytest.mark.parametrize("mode,rtol", [("exact", 1e-5), ("recipe", 2e-2)])
@pytest.mark.parametrize("t", TRANSLATORS)
def test_loop_losses_match_jax(shards, tmp_path, monkeypatch, t, mode, rtol):  # noqa: F811
    """``train_from_config`` with ``model/translator=<t>`` trains 3 steps
    whose logged losses and eval equal the JAX loop's from the same params."""
    extra = EXACT if mode == "exact" else []
    monkeypatch.setattr(jloop, "make_mesh", lambda n_model=1: jmesh.make_mesh(n_model=n_model,
                                                                               devices=jax.devices()[:1]))
    jcfg = jload_config("train_rvfm_imagenet", _loop_overrides(shards, tmp_path / "jax", t, extra))
    jsummary = jloop.train_from_config(jcfg, resume=False)

    tcfg = load_config("train_rvfm_imagenet", _loop_overrides(shards, tmp_path / "port", t, extra))
    _, _, sizes = jloop.select_target_models(jcfg)
    kwargs = dict(jcfg.model.translator.kwargs)
    dtype = jnp.bfloat16 if jcfg.training.compute_dtype == "bfloat16" else jnp.float32
    jmodel = JTheia(backbone=TINY, translator=t, target_feature_sizes=sizes, translator_kwargs=kwargs, dtype=dtype,
                    fuse_preprocessing=bool(jcfg.training.fuse_preprocessing), fast_math=bool(jcfg.training.fast_math))
    params = jmodel.init(jax.random.PRNGKey(jcfg.seed), jnp.zeros((2, 224, 224, 3), jnp.uint8))["params"]
    model = tloop.build_model(tcfg, "cpu")
    model.load_state_dict(state_dict_from_jax(params, sizes, translator=t), strict=True)
    moment = torch.bfloat16 if tcfg.training.moment_dtype == "bfloat16" else None
    state = TrainState.create(dict(model.named_parameters()), toptim.make_optimizer(1e-3, moment_dtype=moment))
    tckpt.save_checkpoint(f"{tcfg.logging.model_path}/{tloop.build_run_identifier(tcfg)}", state, 0)
    tsummary = tloop.train_from_config(tcfg, device="cpu")

    assert tsummary["step"] == jsummary["step"] == 3
    want, got = _losses(tmp_path / "jax" / "logs"), _losses(tmp_path / "port" / "logs")
    assert sorted(got) == sorted(want) == [1, 2, 3]
    np.testing.assert_allclose([got[s] for s in (1, 2, 3)], [want[s] for s in (1, 2, 3)], rtol=rtol)
    for k, v in jsummary["eval"].items():
        np.testing.assert_allclose(tsummary["eval"][k], v, rtol=rtol, err_msg=k)


