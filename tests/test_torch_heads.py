"""The port's translator-head layers and heads against the JAX package.

Tolerances: float32 atol 1e-5 per op and 1e-4 per head (the same math;
cuDNN/oneDNN and XLA order the convolution sums differently, and a head
chains up to three convolutions and three LayerNorms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import layers as jlayers
from theia_tpu.models import translators as jtrans
from theia_tpu_torch.models import layers as tlayers
from theia_tpu_torch.models import translators as ttrans
from theia_tpu_torch.models.adapter_heads import LightConvAdapterHead, LinearAdapterHead
from theia_tpu_torch.models.convert import _translator

RNG = np.random.default_rng(0)


def _nhwc_to_nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize(
    "kind, k, stride, pad, out_pad, size_in, size_out",
    [
        ("convT", 3, 1, 0, 0, 14, 16),  # pad 14 -> 16
        ("convT", 3, 1, 0, 2, 12, 16),  # pad 12 -> 16: output_padding >= stride
        ("convT", 3, 1, 0, 1, 13, 16),
        ("convT", 3, 2, 1, 0, 16, 31),
        ("convT", 3, 2, 0, 1, 31, 64),
        ("conv", 3, 1, 1, 0, 16, 16),
        ("conv", 3, 2, 1, 0, 64, 32),
        ("conv", 4, 2, 1, 0, 14, 7),
    ],
)
def test_conv_layers_shapes_and_values(kind, k, stride, pad, out_pad, size_in, size_out):
    cin, cout = 6, 5
    x = RNG.standard_normal((2, size_in, size_in, cin), dtype=np.float32)
    if kind == "conv":
        jm = jlayers.Conv2dTorch(cout, cin, k, stride=stride, padding=pad)
        tm = tlayers.Conv2dTorch(cin, cout, k, stride=stride, padding=pad)
        to_torch = (3, 2, 0, 1)  # HWIO -> (O,I,kh,kw)
    else:
        jm = jlayers.ConvTranspose2dTorch(cout, cin, k, stride=stride, padding=pad, output_padding=out_pad)
        tm = tlayers.ConvTranspose2dTorch(cin, cout, k, stride=stride, padding=pad, output_padding=out_pad)
        to_torch = (2, 3, 0, 1)  # HWIO -> (I,O,kh,kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm.load_state_dict({
        "weight": torch.from_numpy(np.array(params["kernel"]).transpose(to_torch).copy()),
        "bias": torch.from_numpy(np.array(params["bias"])),
    })
    with torch.no_grad():
        got = tm(_nhwc_to_nchw(x))
    assert tuple(got.shape) == (2, cout, size_out, size_out)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


def test_layer_norm_spatial_matches_jax():
    c, s = 8, 16
    x = 3.0 + 2.0 * RNG.standard_normal((2, s, s, c), dtype=np.float32)
    weight = RNG.standard_normal((c, s, s), dtype=np.float32)
    bias = RNG.standard_normal((c, s, s), dtype=np.float32)
    want = np.asarray(
        jlayers.LayerNormSpatial((c, s, s)).apply({"params": {"weight": weight, "bias": bias}}, jnp.asarray(x))
    )
    tm = tlayers.LayerNormSpatial((c, s, s))
    tm.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        got = tm(_nhwc_to_nchw(x))
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=1e-5, rtol=0)


def test_layer_norm_torch_matches_jax():
    c = 24
    x = 1.0 + RNG.standard_normal((2, 5, c), dtype=np.float32)
    weight = RNG.standard_normal(c, dtype=np.float32)
    bias = RNG.standard_normal(c, dtype=np.float32)
    want = np.asarray(
        jlayers.LayerNormTorch(c).apply({"params": {"weight": weight, "bias": bias}}, jnp.asarray(x))
    )
    tm = tlayers.LayerNormTorch(c)
    assert tm.eps == 1e-5
    tm.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias)})
    with torch.no_grad():
        np.testing.assert_allclose(tm(torch.from_numpy(x)).numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize(
    "source, target, no_cls",
    [
        ((16, 14, 14), (24, 16, 16), False),  # pad to 16, then the same-size ladder
        ((16, 14, 14), (12, 64, 64), False),  # pad to 16, then 16 -> 31 -> 64
        ((16, 16, 16), (12, 64, 64), True),  # 16 -> 64 with no pad, no CLS
        ((16, 14, 14), (24, 14, 14), False),  # same size, no pad
        ((16, 64, 64), (24, 16, 16), False),  # 64 -> 32 -> 16
        ((16, 14, 14), (24, 7, 7), False),  # 14 -> 7
        ((16, 12, 12), (24, 16, 16), False),  # pad 12 -> 16
        ((16, 14, 14), (24,), False),  # "_cls" target: LinearAdapterHead
    ],
)
def test_translator_heads_match_jax(source, target, no_cls):
    name = "teacher/x.y_cls" if len(target) == 1 else "teacher/x.y"
    sizes = {name: target}
    s = source[1]
    tokens = RNG.standard_normal((2, s * s + (0 if no_cls else 1), source[0]), dtype=np.float32)
    jt = jtrans.LightConvFeatureTranslator(backbone_feature_size=source, target_feature_sizes=sizes)
    params = jt.init(jax.random.PRNGKey(0), jnp.asarray(tokens), None, no_cls)["params"]
    want = np.asarray(jt.apply({"params": params}, jnp.asarray(tokens), None, no_cls)[name])
    tt = ttrans.LightConvFeatureTranslator(source, sizes)
    tt.load_state_dict(
        {k.removeprefix("translator."): v for k, v in
         ((k, torch.from_numpy(np.array(v, order="C"))) for k, v in _translator(params, sizes, s).items())},
        strict=True,
    )
    with torch.no_grad():
        got = tt(torch.from_numpy(tokens), backbone_no_cls=no_cls)[name].numpy()
    expect_shape = (2, target[0]) if len(target) == 1 else (2, target[1] * target[2], target[0])
    assert got.shape == want.shape == expect_shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize(
    "source, target",
    [
        ((16, 32, 32), (24, 16, 16)),  # spatial size other than 16 / 64
        ((16, 10, 10), (24, 16, 16)),  # below 12
        ((16, 14, 14), (24, 20, 20)),  # no ladder from 16 to 20
        ((16, 14, 12), (24, 16, 16)),  # non-square
    ],
)
def test_unsupported_geometries_raise(source, target):
    with pytest.raises(NotImplementedError):
        LightConvAdapterHead(source, target)


def test_linear_head_requires_cls():
    head = LinearAdapterHead((16, 14, 14), (24,))
    with pytest.raises(ValueError, match="CLS"):
        head(torch.zeros(1, 196, 16), backbone_no_cls=True)


def test_other_translators_are_not_ported():
    """Every translator of the JAX factory is ported; a type it does not know raises."""
    kw = dict(backbone_feature_size=(16, 14, 14), target_feature_sizes={})
    for t in ("mlp", "conv", "transformer", "trans", "lconv"):
        ttrans.build_feature_translator(t, **kw)
    with pytest.raises(NotImplementedError, match="not implemented"):
        ttrans.build_feature_translator("rnn", **kw)
