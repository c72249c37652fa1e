"""The port's serving Predictor: the non-mesh cases of tests/test_serving.py,
run on the port, plus one case against the JAX Predictor on the same params.

Tolerances: atol 1e-5 between the port's own paths (the same float32 ops on
the same batch; only the padding rows differ); atol 1e-3 against JAX (the
preprocessing rounding flips explained in tests/test_torch_theia.py); bf16
readback within bf16's relative 2^-7.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.serving import Predictor as JPredictor
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.serving import Predictor

NAME = "facebook/deit-tiny-patch16-224"
TARGETS = {"facebook/dinov2-large": (1024, 16, 16)}


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


@pytest.fixture
def model(models):
    return models[0]


def _images(n, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3), np.uint8)


def _direct(model, imgs):
    with torch.no_grad():
        return model.forward_feature(torch.from_numpy(imgs)).numpy()


def test_bucketed_matches_direct(model):
    pred = Predictor(model, buckets=(2, 4))
    for n in (1, 2, 3, 4):  # under, exact, between, top bucket
        imgs = _images(n, seed=n)
        got = pred(imgs)
        assert got.shape[0] == n and got.dtype == np.float32
        np.testing.assert_allclose(got, _direct(model, imgs), atol=1e-5)


def test_oversized_batch_chunks(model):
    pred = Predictor(model, buckets=(2, 4))
    imgs = _images(9)  # 4 + 4 + 1 (padded to 2)
    np.testing.assert_allclose(pred(imgs), _direct(model, imgs), atol=1e-5)


def test_predict_dict_method(model):
    pred = Predictor(model, buckets=(2,), method="predict")
    out = pred(_images(3))
    assert set(out) == set(TARGETS)
    assert out["facebook/dinov2-large"].shape == (3, 256, 1024)
    with pytest.raises(ValueError, match="unknown method"):
        Predictor(model, method="train")


def test_stream_order_and_values(model):
    pred = Predictor(model, buckets=(2, 4))
    batches = [_images(n, seed=10 + n) for n in (1, 4, 3)]
    streamed = list(pred.predict_stream(iter(batches)))
    assert [s.shape[0] for s in streamed] == [1, 4, 3]
    for imgs, got in zip(batches, streamed):
        np.testing.assert_allclose(got, pred(imgs), atol=1e-5)


def test_stream_depth_keeps_batches_in_flight(model):
    """With depth=2 the first result is read back only after batch 3 entered."""
    pred = Predictor(model, buckets=(2,), depth=2)
    events = []

    def gen():
        for i, n in enumerate((1, 2, 2, 1)):
            events.append(("in", i))
            yield _images(n, seed=40 + i)

    for j, _ in enumerate(pred.predict_stream(gen())):
        events.append(("out", j))
    assert events.index(("out", 0)) > events.index(("in", 2))
    assert [e for e in events if e[0] == "out"] == [("out", j) for j in range(4)]


def test_stream_oversized_batch_chunks(model):
    """Oversized stream batches are chunked by the top bucket and reassembled."""
    pred = Predictor(model, buckets=(2, 4))
    seen: list[int] = []
    orig = pred._fn

    def spy(x):
        seen.append(x.shape[0])
        return orig(x)

    pred._fn = spy
    batches = [_images(9, seed=1), _images(2, seed=2)]
    streamed = list(pred.predict_stream(iter(batches)))
    assert [s.shape[0] for s in streamed] == [9, 2]
    assert set(seen) <= {2, 4}, f"non-bucket shapes dispatched: {seen}"
    for imgs, got in zip(batches, streamed):
        np.testing.assert_allclose(got, pred(imgs), atol=1e-5)


def test_bf16_readback(model):
    exact = Predictor(model, buckets=(2,))
    narrow = Predictor(model, buckets=(2,), out_dtype=torch.bfloat16)
    imgs = _images(3, seed=5)
    want = exact(imgs)
    got = narrow(imgs)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7)
    (s,) = list(narrow.predict_stream(iter([imgs])))
    np.testing.assert_allclose(s, got, atol=0)


@pytest.mark.parametrize("method", ["forward_feature", "predict"])
def test_matches_jax_predictor(models, method):
    model, jmodel, params = models
    imgs = _images(5, seed=7)
    want = JPredictor(jmodel, params, buckets=(2, 4), method=method)(imgs)
    got = Predictor(model, buckets=(2, 4), method=method)(imgs)
    if method == "predict":
        got, want = got["facebook/dinov2-large"], want["facebook/dinov2-large"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=0)


def test_replicas_match_jax_mesh_predictor(models):
    """``devices=["cpu", "cpu"]`` against the JAX Predictor over a mesh of
    two CPU devices: the same buckets (each rounded up to a multiple of 2),
    outputs within the JAX tolerance above and within 1e-5 of one replica."""
    from theia_tpu.parallel.mesh import make_mesh

    model, jmodel, params = models
    jpred = JPredictor(jmodel, params, buckets=(1, 3, 4), mesh=make_mesh(n_data=2, devices=jax.devices()[:2]))
    pred = Predictor(model, buckets=(1, 3, 4), devices=["cpu", "cpu"])
    assert pred._buckets == jpred._buckets == (2, 4)
    imgs = _images(5, seed=9)  # 4 + 1 (padded to 2)
    got = pred(imgs)
    np.testing.assert_allclose(got, np.asarray(jpred(imgs)), atol=1e-3, rtol=0)
    np.testing.assert_allclose(got, Predictor(model, buckets=(2, 4))(imgs), atol=1e-5)


def test_replicas_split_each_padded_batch_in_order(model):
    pred = Predictor(model, buckets=(4,), method="predict", devices=["cpu", "cpu"])
    assert pred._fn is model and pred._replica_fns[0] is not model  # the second replica is a copy
    seen = []
    fns = [pred._fn, *pred._replica_fns]

    def spy(i):
        def fn(x):
            seen.append((i, x[:, 0, 0, 0].tolist()))
            return fns[i](x)
        return fn

    pred._fn, pred._replica_fns = spy(0), [spy(1)]
    imgs = _images(3, seed=11)
    out = pred(imgs)
    assert seen == [(0, imgs[:2, 0, 0, 0].tolist()), (1, [int(imgs[2, 0, 0, 0]), 0])]
    want = Predictor(model, buckets=(4,), method="predict")(imgs)
    np.testing.assert_allclose(out["facebook/dinov2-large"], want["facebook/dinov2-large"], atol=1e-5)
    streamed = list(Predictor(model, buckets=(2,), devices=["cpu", "cpu"]).predict_stream(iter([imgs, imgs[:1]])))
    assert [s.shape[0] for s in streamed] == [3, 1]
