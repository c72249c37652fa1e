"""The port's Theia against the JAX package on the same parameters.

``state_dict_from_jax`` must equal the JAX package's own reference-layout
export key for key and bitwise, and load with ``strict=True``. Forward
tolerance on uint8 images: atol 1e-3. It is looser than the backbone's 1e-4
(tests/test_torch_vit.py) because a few preprocessing pixels may round one
uint8 step apart in the two packages (float32 sums in another order at the
.5 boundary of the PIL-emulating pass). The training recipe's model
(``fast_math``, ``fuse_preprocessing``), which has no rounding pass: float32
atol 1e-4; bf16 relative L2 < 2e-2 per output (bf16 rounds at other places
in XLA and in PyTorch; see tests/test_torch_vit.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.models.hf_convert import export_theia_checkpoint
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu_torch.foundation.common import get_model_feature_size
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.hub import TEACHER_SETS
from theia_tpu_torch.models.rvfm import Theia as TTheia

TINY = "facebook/deit-tiny-patch16-224"
REG = "reg-facebook/deit-tiny-patch16-224"
CDDSV = {t: get_model_feature_size(t, keep_spatial=True) for t in TEACHER_SETS["cddsv"]}


@pytest.fixture(scope="module", autouse=True)
def two_layer_backbones():
    saved = [(configs, name, configs[name]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)
             for name in (TINY, REG)]
    for configs, name, cfg in saved:
        configs[name] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, name, cfg in saved:
        configs[name] = cfg


def _images(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 224, 224, 3), dtype=np.uint8)


def _pair(backbone, sizes, variant, dtypes=(jnp.float32, torch.float32), **flags):
    jmodel = JTheia(backbone=backbone, translator="lconv", target_feature_sizes=sizes, dtype=dtypes[0], **flags)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
    tmodel = TTheia(backbone=backbone, translator="lconv", target_feature_sizes=sizes, dtype=dtypes[1], **flags)
    tmodel.load_state_dict(state_dict_from_jax(params, sizes, variant=variant), strict=True)
    return jmodel, params, tmodel.eval()


@pytest.fixture(scope="module")
def cddsv_pair():
    return _pair(TINY, CDDSV, "cls")


@pytest.mark.parametrize("variant", ["cls", "reg"])
def test_state_dict_equals_reference_export(variant, cddsv_pair):
    if variant == "cls":
        _, params, tmodel = cddsv_pair
    else:
        _, params, tmodel = _pair(REG, CDDSV, "reg")
    want = export_theia_checkpoint(params, CDDSV, variant=variant)
    got = state_dict_from_jax(params, CDDSV, variant=variant)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    assert set(tmodel.state_dict()) == set(want)


def test_forward_feature_and_predict_match_jax(cddsv_pair):
    jmodel, params, tmodel = cddsv_pair
    imgs = _images(2)
    want_feat = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs), method=jmodel.forward_feature))
    want = jmodel.apply({"params": params}, jnp.asarray(imgs))
    with torch.no_grad():
        got_feat = tmodel.forward_feature(torch.from_numpy(imgs)).numpy()
        got = tmodel(torch.from_numpy(imgs))
    assert got_feat.shape == want_feat.shape == (2, 196, 192)
    np.testing.assert_allclose(got_feat, want_feat, atol=1e-3, rtol=0)
    assert list(got) == list(CDDSV)
    for t, (c, h, w) in CDDSV.items():
        assert tuple(got[t].shape) == (2, h * w, c)
        np.testing.assert_allclose(got[t].numpy(), np.asarray(want[t]), atol=1e-3, rtol=0, err_msg=t)


def test_flash_attention_forward_feature_matches_jax(monkeypatch):
    """The exact-mode Theia with attention_impl="flash" (the plain flash
    versions on the CPU; JAX runs einsum there), at 224² and on 448² images
    without resize and with interpolated position embeddings (T = 785)."""
    monkeypatch.setitem(tvit.BACKBONE_CONFIGS, TINY, dataclasses.replace(tvit.BACKBONE_CONFIGS[TINY],
                                                                         attention_impl="flash"))
    jmodel, params, tmodel = _pair(TINY, CDDSV, "cls")
    assert tmodel.backbone.cfg.attention_impl == "flash"
    rng = np.random.default_rng(7)
    for imgs, kw, tokens in ((_images(2, seed=6), {}, 196),
                             (rng.integers(0, 256, (1, 448, 448, 3), dtype=np.uint8),
                              dict(do_resize=False, interpolate_pos_encoding=True), 784)):
        want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs), method=jmodel.forward_feature, **kw))
        with torch.no_grad():
            got = tmodel.forward_feature(torch.from_numpy(imgs), **kw).numpy()
        assert got.shape == want.shape == (len(imgs), tokens, 192)
        np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_model_matches_jax(dtype):
    """The training recipe's model: fast_math and fuse_preprocessing."""
    dtypes = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jmodel, params, tmodel = _pair(TINY, CDDSV, "cls", dtypes, fast_math=True, fuse_preprocessing=True)
    imgs = _images(2, seed=5)
    want = {"feature": jmodel.apply({"params": params}, jnp.asarray(imgs), method=jmodel.forward_feature),
            **jmodel.apply({"params": params}, jnp.asarray(imgs))}
    with torch.no_grad():
        got = {"feature": tmodel.forward_feature(torch.from_numpy(imgs)), **tmodel(torch.from_numpy(imgs))}
    assert list(got) == list(want)
    for k, w in want.items():
        g, w = got[k].float().numpy(), np.asarray(w, np.float32)
        assert got[k].dtype == dtypes[1] and g.shape == w.shape, k
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=k)
        else:
            assert float(np.linalg.norm(g - w) / np.linalg.norm(w)) < 2e-2, k


def test_reg_variant_drops_register_tokens():
    sizes = {"facebook/dinov2-large": CDDSV["facebook/dinov2-large"]}
    jmodel, params, tmodel = _pair(REG, sizes, "reg")
    assert tmodel.num_reg == 7
    imgs = _images(2, seed=1)
    want_feat = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs), method=jmodel.forward_feature))
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs))["facebook/dinov2-large"])
    with torch.no_grad():
        tokens = tmodel.backbone(torch.from_numpy(imgs))
        got_feat = tmodel.forward_feature(torch.from_numpy(imgs)).numpy()
        got = tmodel(torch.from_numpy(imgs))["facebook/dinov2-large"].numpy()
    assert tokens.shape[1] == 1 + 196 + 7
    assert got_feat.shape == want_feat.shape == (2, 196, 192)  # CLS and registers dropped
    np.testing.assert_allclose(got_feat, want_feat, atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=0)


def test_build_theia_defaults_to_the_gpu():
    """The entry point runs on the card unless the caller asks for the CPU."""
    import inspect

    from theia_tpu_torch.models.hub import build_theia

    params = inspect.signature(build_theia).parameters
    assert params["device"].default == "cuda"
    assert params["dtype"].default == params["param_dtype"].default == torch.float32


def test_build_theia_compute_dtype_over_float32_params():
    from theia_tpu_torch.models.hub import build_theia

    model = build_theia("theia-tiny-patch16-224-cdiv", dtype=torch.bfloat16, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert model.dtype == model.backbone.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.translator.translator_heads["facebook/dinov2-large"].adapter[0].compute_dtype == torch.bfloat16


def test_bf16_compute_over_float32_params_matches_bf16_storage():
    """bf16 compute over float32 params (cast at each use, as in JAX) and the
    same params stored in bf16 (serving) agree within bf16's own error. The
    params are bf16 values, so every cast at use is exact; the one
    difference is the encoder LayerNorm: float32 with the float32 params,
    then cast (as flax computes it), against torch's fused bf16 LayerNorm
    for bf16 params, which also computes in float32 inside. The two round
    a few in 10^5 outputs the other way; the next matmul spreads each such
    flip over a row, and from there the two runs round independently.
    Tolerance: the two closer to each other than the bf16 run is to the
    float32 run of the same params (backbone relative L2 ~1.6e-3 against
    ~4.8e-3, heads ~6.3e-3 against ~9.5e-3)."""
    model = TTheia(backbone=TINY, translator="lconv", target_feature_sizes=CDDSV, dtype=torch.bfloat16)
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.to(torch.bfloat16))  # bf16 values in float32 storage
    stored = TTheia(backbone=TINY, translator="lconv", target_feature_sizes=CDDSV, dtype=torch.bfloat16)
    stored.load_state_dict(model.state_dict())
    stored.to(torch.bfloat16)
    exact = TTheia(backbone=TINY, translator="lconv", target_feature_sizes=CDDSV)
    exact.load_state_dict(model.state_dict())
    imgs = torch.from_numpy(_images(2, seed=4))
    with torch.no_grad():
        outs = [(m.forward_feature(imgs), m(imgs)) for m in (model, stored, exact)]
    assert outs[0][0].dtype == outs[1][0].dtype == torch.bfloat16
    for i, t in enumerate([None, *CDDSV]):
        a, b, f = (o[0] if t is None else o[1][t] for o in outs)
        rel = float((a.float() - b.float()).norm() / b.float().norm())
        bf16_err = float((b.float() - f).norm() / f.norm())
        assert rel < bf16_err, (t, rel, bf16_err)
