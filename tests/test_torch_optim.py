"""The port's optimizer pieces against the JAX package: LR schedules step by
step, masked AdamW over several updates with random grads and masks
(params, moments, per-parameter counts; bf16 moments; translator LR
factor), the weight-decay mask through the name map, and grad clipping.

Tolerances: schedules rtol 1e-6 and atol 1e-9 (float32 arithmetic on both
sides; near the cosine's floor a float32 cos may differ by ~1e-10);
AdamW parameters atol 1e-6 after 6 steps of lr 1e-3 (float32; pow and sqrt
may differ in the last ulp), float32 moments rtol 1e-5, bf16 moments within
one bf16 ulp (2^-7 relative: the float32 values they round from may
differ in the last ulp); clipped grads rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.train import optim as joptim
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.train import optim as toptim

# port name -> (JAX tree path, shape)
LEAVES = {
    "backbone.model.embeddings.position_embeddings": (("backbone_module", "position_embeddings"), (1, 5, 4)),
    "backbone.model.embeddings.patch_embeddings.projection.bias": (("backbone_module", "patch_bias"), (4,)),
    "backbone.model.layernorm.weight": (("backbone_module", "layernorm", "scale"), (4,)),
    "translator.translator_heads.t.adapter.0.weight": (("translator_module", "head_t", "adapter_0", "weight"), (3, 2, 2)),
    "translator.translator_heads.t.adapter.0.bias": (("translator_module", "head_t", "adapter_0", "bias"), (3, 2, 2)),
    "translator.translator_heads.t.adapter.8.weight": (("translator_module", "head_t", "adapter_8", "kernel"), (6, 3)),
}


def _tree(values):
    tree = {}
    for name, (path, _) in LEAVES.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = jnp.asarray(values[name])
    return tree


def _leaf(tree, name):
    for key in LEAVES[name][0]:
        tree = tree[key]
    return np.asarray(tree, np.float32)


@pytest.mark.parametrize("warm", [0, 1, 10])
def test_schedules_match_jax(warm):
    pairs = [
        (joptim.constant_with_warmup(2e-3, warm), toptim.constant_with_warmup(2e-3, warm)),
        (joptim.cosine_restarts_with_warmup(2e-3, warm, 40), toptim.cosine_restarts_with_warmup(2e-3, warm, 40)),
        (joptim.constant_with_warmup(1e-3, warm, 0.1), toptim.constant_with_warmup(1e-3, warm, 0.1)),
    ]
    for jsched, tsched in pairs:
        want = np.asarray([float(jsched(i)) for i in range(100)])
        got = np.asarray([float(tsched(i)) for i in range(100)])
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
        step = torch.tensor(7, dtype=torch.int32)  # a device-style int32 step count
        np.testing.assert_allclose(float(tsched(step)), float(jsched(jnp.int32(7))), rtol=1e-6)


def test_scaled_lr_matches_jax():
    assert toptim.scaled_lr(2e-3, 16, 1) == joptim.scaled_lr(2e-3, 16, 1) == 2e-3 * 16 / 512
    assert toptim.scaled_lr(1e-3, 32, 4, 16, 2) == joptim.scaled_lr(1e-3, 32, 4, 16, 2)


@pytest.mark.parametrize("moment_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("lr_factor", [1.0, 0.5])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_adamw_matches_jax(moment_dtype, lr_factor, masked):
    rng = np.random.default_rng(0)
    values = {n: rng.standard_normal(shape).astype(np.float32) for n, (_, shape) in LEAVES.items()}
    jparams = _tree(values)
    tparams = {n: torch.from_numpy(v.copy()) for n, v in values.items()}
    kw = dict(weight_decay=0.01, translator_lr_factor=lr_factor)
    jtx = joptim.make_optimizer(joptim.constant_with_warmup(1e-3, 2), moment_dtype=moment_dtype and jnp.bfloat16, **kw)
    ttx = toptim.make_optimizer(toptim.constant_with_warmup(1e-3, 2), moment_dtype=moment_dtype and torch.bfloat16, **kw)
    jstate, tstate = jtx.init(jparams), ttx.init(tparams)
    for _ in range(6):
        grads = {n: rng.standard_normal(v.shape).astype(np.float32) for n, v in values.items()}
        mask = {n: float(rng.integers(0, 2)) for n in values} if masked else None
        kwargs = {} if mask is None else {"mask": jax.tree.map(jnp.asarray, _tree(mask))}
        updates, jstate = jtx.update(_tree(grads), jstate, jparams, **kwargs)
        jparams = optax.apply_updates(jparams, updates)
        ttx.update({n: torch.from_numpy(g) for n, g in grads.items()}, tstate, tparams, mask=mask)
    bf16 = moment_dtype is not None
    for n in LEAVES:
        np.testing.assert_allclose(tparams[n].numpy(), _leaf(jparams, n), atol=1e-6, rtol=0, err_msg=n)
        for tm, jm in ((tstate.mu, jstate.mu), (tstate.nu, jstate.nu)):
            assert tm[n].dtype == (torch.bfloat16 if bf16 else torch.float32)
            np.testing.assert_allclose(tm[n].float().numpy(), _leaf(jm, n), rtol=2**-7 if bf16 else 1e-5,
                                       atol=1e-30, err_msg=n)
        assert int(tstate.count[n]) == int(_leaf(jstate.count, n))
    assert int(tstate.sched_count) == int(jstate.sched_count) == 6


def test_masked_leaf_is_frozen_completely():
    p = {"translator.a.weight": torch.ones(2, 2), "backbone.b.weight": torch.ones(2, 2)}
    before = {n: v.clone() for n, v in p.items()}
    tx = toptim.make_optimizer(1e-2)
    state = tx.init(p)
    for _ in range(3):
        tx.update({n: torch.ones(2, 2) for n in p}, state, p, mask={"translator.a.weight": torch.tensor(0.0)})
    assert torch.equal(p["translator.a.weight"], before["translator.a.weight"])
    assert int(state.count["translator.a.weight"]) == 0 and float(state.mu["translator.a.weight"].abs().max()) == 0.0
    assert int(state.count["backbone.b.weight"]) == 3
    assert not torch.equal(p["backbone.b.weight"], before["backbone.b.weight"])


def test_weight_decay_mask_through_the_name_map():
    """The JAX mask over the tiny Theia's param tree, mapped into the port's
    names by ``state_dict_from_jax``, equals the port's mask over its own
    parameters."""
    name = "facebook/deit-tiny-patch16-224"
    sizes = {"teacher/a": (24, 16, 16), "teacher/b": (12, 64, 64), "teacher/c_cls": (16,)}
    saved = [(c, c[name]) for c in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    try:
        for c, cfg in saved:
            c[name] = dataclasses.replace(cfg, num_layers=1)
        params = JTheia(backbone=name, translator="lconv", target_feature_sizes=sizes).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
        model = TTheia(backbone=name, translator="lconv", target_feature_sizes=sizes)
    finally:
        for c, cfg in saved:
            c[name] = cfg
    jmask = joptim.no_weight_decay_mask(params)
    mapped = state_dict_from_jax(jax.tree.map(lambda m, p: np.full(p.shape, float(m), np.float32), jmask, params), sizes)
    tmask = toptim.no_weight_decay_mask(dict(model.named_parameters()))
    assert set(mapped) == set(tmask)
    for n, m in mapped.items():
        assert bool(m.reshape(-1)[0]) == tmask[n], n
    assert tmask["translator.translator_heads.teacher/a.adapter.0.weight"]  # (C,H,W) LayerNorm weights decay
    assert not tmask["backbone.model.layernorm.weight"]


def test_clip_grad_norm_matches_jax():
    rng = np.random.default_rng(1)
    grads = {n: rng.standard_normal(shape).astype(np.float32) for n, (_, shape) in LEAVES.items()}
    for max_norm in (0.5, 100.0):
        jclipped, jnorm = joptim.clip_grad_norm(_tree(grads), max_norm)
        clipped, norm = toptim.clip_grad_norm({n: torch.from_numpy(g) for n, g in grads.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
        for n in LEAVES:
            np.testing.assert_allclose(clipped[n].numpy(), _leaf(jclipped, n), rtol=1e-6, atol=1e-7)
