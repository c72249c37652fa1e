"""The port's deployment artifact (theia_tpu_torch/export.py) on the CPU:
round trips against ``serving.Predictor`` and the JAX package's StableHLO
artifact of the same params (theia_tpu/export.py), batch-polymorphic, with
the attention kernels' operators in the graph.

Tolerances: float32 atol 1e-5 against the port's own Predictor (the same
float32 ops; only the padding rows differ), bf16 readback within bf16's
relative 2^-7, atol 1e-3 against JAX (tests/test_torch_serving.py's).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu import export as jexport
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu_torch import export as texport
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.hub import PretrainedTheia
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.serving import Predictor

NAME = "facebook/deit-tiny-patch16-224"
TARGETS = {"facebook/dinov2-large": (1024, 16, 16)}
BF16 = 2.0 ** -7


@pytest.fixture(scope="module")
def models():
    saved = [(configs, configs[NAME]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[NAME] = dataclasses.replace(cfg, num_layers=2)
    try:
        jmodel = JTheia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS)
        params = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
        model = Theia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS)
        model.load_state_dict(state_dict_from_jax(params, TARGETS), strict=True)
        yield model.eval(), jmodel, params
    finally:
        for configs, cfg in saved:
            configs[NAME] = cfg


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3), np.uint8)


def _ops(pred):
    return {str(n.target) for n in pred.program.graph.nodes if n.op == "call_function"}


def test_round_trip_matches_predictor(models, tmp_path):
    model = models[0]
    path = str(tmp_path / "theia.pt2")
    texport.save_artifact(path, model)
    pred = texport.load_artifact(path)
    assert pred.meta == {"method": "forward_feature", "image_size": 224, "channels": 3, "out_dtype": None,
                         "platforms": ["cpu"]}
    assert "theia.mha_attention.default" in _ops(pred)
    direct = Predictor(model, buckets=(1, 4))
    for n in (1, 3):  # batch-polymorphic: one artifact, two batch sizes
        imgs = _images(n, seed=n)
        got, want = pred(imgs), direct(imgs)
        assert got.dtype == np.float32 and got.shape == want.shape == (n, 196, 192)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("method", ["forward_feature", "predict"])
def test_bf16_readback_matches_predictor(models, method):
    model = models[0]
    pred = texport.ExportedPredictor(texport.export_model(model, method=method, out_dtype=torch.bfloat16))
    assert pred.meta["method"] == method and pred.meta["out_dtype"] == "bfloat16"
    imgs = _images(2)
    got = pred(imgs)
    want = Predictor(model, buckets=(2,), method=method, out_dtype=torch.bfloat16)(imgs)
    if method == "predict":
        assert set(got) == set(want) == set(TARGETS)
        got, want = got["facebook/dinov2-large"], want["facebook/dinov2-large"]
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=BF16, atol=BF16)


def test_agrees_with_the_jax_artifact(models, tmp_path):
    model, jmodel, params = models
    jpath, tpath = str(tmp_path / "theia.stablehlo"), str(tmp_path / "theia.pt2")
    jexport.save_artifact(jpath, jmodel, params, platforms=("cpu",))
    texport.save_artifact(tpath, model)
    jpred, tpred = jexport.load_artifact(jpath), texport.load_artifact(tpath)
    assert tpred.meta["method"] == jpred.meta["method"] and tpred.meta["out_dtype"] == jpred.meta["out_dtype"]
    for n in (1, 3):
        imgs = _images(n, seed=10 + n)
        np.testing.assert_allclose(tpred(imgs), jpred(imgs), atol=1e-3, rtol=0)


def test_rejects_garbage(models, tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"not an artifact")
    with pytest.raises(ValueError, match="AOT artifact"):
        texport.load_artifact(str(p))
    jblob = jexport.export_model(models[1], models[2], platforms=("cpu",))
    with pytest.raises(ValueError, match="AOT artifact"):  # the JAX package's artifact is another format
        texport.ExportedPredictor(jblob)
    with pytest.raises(ValueError, match="unknown method"):
        texport.export_model(models[0], method="backbone")
    with pytest.raises(TypeError):
        texport.export_model(torch.nn.Linear(2, 2))


def test_pretrained_wrapper_accepted(models):
    """A ``PretrainedTheia`` exports with its own reduce method."""
    wrapped = PretrainedTheia(models[0], feature_reduce_method="mean_pooling")
    pred = texport.ExportedPredictor(texport.export_model(wrapped))
    imgs = _images(3, seed=4)
    got = pred(imgs)
    with torch.no_grad():
        want = wrapped.forward_feature(torch.from_numpy(imgs)).numpy()
    assert got.shape == (3, 192)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    with torch.no_grad():  # the trace left no stand-in in the model's cached constants
        assert type(models[0].forward_feature(torch.from_numpy(imgs))) is torch.Tensor


def test_flash_attention_operator_in_the_graph(models):
    model = models[0]
    saved = tvit.BACKBONE_CONFIGS[NAME]
    tvit.BACKBONE_CONFIGS[NAME] = dataclasses.replace(saved, attention_impl="flash")
    try:
        flash = Theia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS).eval()
    finally:
        tvit.BACKBONE_CONFIGS[NAME] = saved
    flash.load_state_dict(model.state_dict())
    pred = texport.ExportedPredictor(texport.export_model(flash))
    assert "theia.flash_attention.default" in _ops(pred) and "theia.mha_attention.default" not in _ops(pred)
    imgs = _images(2, seed=5)
    np.testing.assert_allclose(pred(imgs), Predictor(model, buckets=(2,))(imgs), atol=1e-5, rtol=0)
