"""The port's preprocessing and ViT backbone against the JAX package.

Tolerances:
  - resize matrices: bitwise (the same numpy code);
  - ``preprocess_images``: equal, except that at most 0.01% of elements may
    differ by exactly one uint8 step (1/127.5 after normalisation): float32
    sums in another order flip ``round()`` at the .5 boundary of the
    PIL-emulating pass;
  - ``ViTBackbone`` on pre-normalised float input: atol 1e-4 (float32
    through 2 blocks; LayerNorm variance as E[x²]−E[x]² in flax, Welford in
    torch), under ``fast_math`` too;
  - ``fast_math`` in bf16: relative L2 < 1e-2 over the tokens (~2.6e-3
    seen): torch's bf16 softmax and GELU compute in float32 inside and round
    once, XLA's CPU bf16 ops round after each op; the same size as JAX's own
    fast_math-vs-exact gap in bf16 (~2.4e-3);
  - ``_fused_resize_patch_matrix``: bitwise (the same numpy code);
  - ``_fused_embed``: float32 atol 1e-5 (~3e-6 seen: a 20x20x3 composite
    kernel contracted in another order, then a convolution in another
    order); bf16 relative L2 < 1e-3 (outputs one bf16 step apart, ~1.6e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.ops import image as jimage
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.ops import image as timage

NAMES = {
    "cls": "facebook/deit-tiny-patch16-224",
    "nocls": "nocls-facebook/deit-tiny-patch16-224",
    "reg": "reg-facebook/deit-tiny-patch16-224",
}


@pytest.mark.parametrize(
    "args",
    [
        (224, 256, -0.5, None, True),
        (480, 256, -0.5, None, True),  # downscale: antialiased support
        (320, 256, -0.5, None, True),
        (14, 16, -0.75, (16 + 0.1) / 14, False),  # pos-embed quirk
        (14, 20, -0.75, None, False),
    ],
)
def test_resize_matrices_bitwise(args):
    np.testing.assert_array_equal(timage._resize_matrix(*args), jimage._resize_matrix(*args))


def test_patch_embed_weight_layout():
    """JAX's matmul patch kernel ((kh,kw,3) flattened, C) and the port's conv
    weight (C,3,kh,kw) hold the same numbers."""
    name = NAMES["cls"]
    cfg = dataclasses.replace(jvit.BACKBONE_CONFIGS[name], num_layers=1)
    params = jvit.ViTBackbone(cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
    sd = state_dict_from_jax({"backbone_module": params}, {})
    w = sd["backbone.model.embeddings.patch_embeddings.projection.weight"]
    assert w.shape == (192, 3, 16, 16)
    np.testing.assert_array_equal(w.permute(2, 3, 1, 0).reshape(-1, 192).numpy(), np.asarray(params["patch_kernel"]))


def _assert_preprocess_close(got, want):
    diff = np.abs(got - want)
    flipped = diff > 1e-6
    np.testing.assert_allclose(diff[flipped], 1 / 127.5, atol=1e-5)
    assert flipped.mean() <= 1e-4, f"{flipped.sum()} of {flipped.size} elements flipped"


@pytest.mark.parametrize("hw", [(224, 224), (240, 320)])
def test_preprocess_images_matches_jax(hw):
    imgs = np.random.default_rng(0).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    want = np.asarray(jimage.preprocess_images(jnp.asarray(imgs)))
    got = timage.preprocess_images(torch.from_numpy(imgs))
    assert tuple(got.shape) == want.shape == (2, 224, 224, 3)
    _assert_preprocess_close(got.numpy(), want)
    # channels-first input gives the same result
    got_nchw = timage.preprocess_images(torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_array_equal(got_nchw.numpy(), got.numpy())


def _backbones(variant, fast_math=False, dtypes=(jnp.float32, torch.float32), fuse_preprocessing=False,
               attention_impl="pallas"):
    name = NAMES[variant]
    cfg = dataclasses.replace(jvit.BACKBONE_CONFIGS[name], num_layers=2, fast_math=fast_math)
    num_reg = 7 if variant == "reg" else 0
    jmodel = jvit.ViTBackbone(cfg, variant=variant, num_reg_tokens=num_reg, dtype=dtypes[0],
                              fuse_preprocessing=fuse_preprocessing)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3), jnp.float32), False)["params"]
    tcfg = dataclasses.replace(tvit.BACKBONE_CONFIGS[name], num_layers=2, fast_math=fast_math,
                               attention_impl=attention_impl)
    tmodel = tvit.ViTBackbone(tcfg, variant=variant, num_reg_tokens=num_reg, dtype=dtypes[1],
                              fuse_preprocessing=fuse_preprocessing)
    sd = state_dict_from_jax({"backbone_module": params}, {}, variant=variant)
    tmodel.load_state_dict({k.removeprefix("backbone."): v for k, v in sd.items()}, strict=True)
    return jmodel, params, tmodel.eval()


FLAGS = dict(do_resize=False, do_rescale=False, do_normalize=False)


@pytest.mark.parametrize("variant", ["cls", "nocls", "reg"])
def test_backbone_matches_jax(variant):
    jmodel, params, tmodel = _backbones(variant)
    x = np.random.default_rng(2).standard_normal((2, 224, 224, 3), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), **FLAGS))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), **FLAGS).numpy()
    assert got.shape == want.shape == (2, {"cls": 197, "nocls": 196, "reg": 204}[variant], 192)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_backbone_interpolate_pos_encoding_matches_jax():
    jmodel, params, tmodel = _backbones("cls")
    x = np.random.default_rng(3).standard_normal((1, 240, 240, 3), dtype=np.float32)
    want = np.asarray(
        jmodel.apply({"params": params}, jnp.asarray(x), interpolate_pos_encoding=True, **FLAGS)
    )
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), interpolate_pos_encoding=True, **FLAGS).numpy()
    assert got.shape == want.shape == (1, 1 + 15 * 15, 192)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("variant", ["cls", "reg"])
def test_flash_backbone_matches_jax(variant):
    """attention_impl="flash": the port's flash path (its plain versions on
    the CPU) against the JAX backbone (einsum attention off the TPU)."""
    jmodel, params, tmodel = _backbones(variant, attention_impl="flash")
    x = np.random.default_rng(4).standard_normal((2, 224, 224, 3), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), **FLAGS))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), **FLAGS).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("attention_impl", ["flash", "pallas"])
def test_448_images_with_interpolated_pos_encoding_match_jax(attention_impl):
    """uint8 448² images, no resize, interpolated position embeddings:
    T = 1 + 28² = 785, past K1/K2's 256, so "pallas" takes the flash route
    too. Without the resize no rounding pass runs, so the backbone's atol
    holds."""
    jmodel, params, tmodel = _backbones("cls", attention_impl=attention_impl)
    imgs = np.random.default_rng(6).integers(0, 256, (1, 448, 448, 3), dtype=np.uint8)
    kw = dict(do_resize=False, interpolate_pos_encoding=True)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs), **kw))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(imgs), **kw).numpy()
    assert got.shape == want.shape == (1, 785, 192)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("fuse_preprocessing, size", [(False, 240), (True, 224)])
def test_training_after_inference_mode_serving(fuse_preprocessing, size):
    """Constants cached on the device by a call under torch.inference_mode()
    (the resize matrices of the position-embedding interpolation, the fused
    embed's scale and shift) stay usable by a later step that autograd
    differentiates: the gradients equal those of a run with nothing cached."""
    _, _, tmodel = _backbones("cls", fuse_preprocessing=fuse_preprocessing)
    imgs = torch.from_numpy(np.random.default_rng(8).integers(0, 256, (1, size, size, 3), dtype=np.uint8))
    kw = dict(do_resize=False, interpolate_pos_encoding=True) if size != 224 else {}

    def grads():
        (g,) = torch.autograd.grad(tmodel(imgs, **kw).square().sum(), tmodel.model.embeddings.position_embeddings)
        return g

    for f in (timage._resize_matrix_on, timage._channel_constant, tvit._fused_constants):
        f.cache_clear()
    want = grads()
    for f in (timage._resize_matrix_on, timage._channel_constant, tvit._fused_constants):
        f.cache_clear()
    with torch.inference_mode():
        tmodel(imgs, **kw)
    torch.testing.assert_close(grads(), want, atol=0, rtol=0)


DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("variant, dtype", [("cls", "float32"), ("reg", "float32"), ("cls", "bfloat16")])
def test_fast_math_backbone_matches_jax(variant, dtype):
    jmodel, params, tmodel = _backbones(variant, fast_math=True, dtypes=DTYPES[dtype])
    x = np.random.default_rng(2).standard_normal((2, 224, 224, 3), dtype=np.float32)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(x), **FLAGS), np.float32)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), **FLAGS)
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    else:
        assert _rel_l2(got.float().numpy(), want) < 1e-2


def test_fast_math_does_not_run_the_attention_kernels(monkeypatch):
    """Under fast_math the block never reaches ``packed_attention`` (K1/K2)."""
    _, _, tmodel = _backbones("cls", fast_math=True)

    def refuse(*args, **kwargs):
        raise AssertionError("packed_attention called under fast_math")

    monkeypatch.setattr(tvit, "packed_attention", refuse)
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 224, 224, 3), dtype=np.float32))
    tmodel(x, **FLAGS).sum().backward()


@pytest.mark.parametrize("geometry", [(224, 256, 224, 16), (112, 128, 112, 16), (224, 256, 224, 8)])
def test_fused_resize_patch_matrix_equals_jax(geometry):
    got, want = tvit._fused_resize_patch_matrix(*geometry), jvit._fused_resize_patch_matrix(*geometry)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["nhwc", "nchw"])
def test_fused_embed_matches_jax(dtype, layout):
    jmodel, params, tmodel = _backbones("cls", dtypes=DTYPES[dtype], fuse_preprocessing=True)
    imgs = np.random.default_rng(4).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)
    want = np.asarray(jmodel.apply({"params": params}, jnp.asarray(imgs), method=jmodel._fused_embed), np.float32)
    x = imgs if layout == "nhwc" else imgs.transpose(0, 3, 1, 2).copy()
    with torch.no_grad():
        got = tmodel._fused_embed(torch.from_numpy(x))
    assert got.dtype == DTYPES[dtype][1] and tuple(got.shape) == want.shape == (2, 196, 192)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    else:
        assert _rel_l2(got.float().numpy(), want) < 1e-3


def test_fused_preprocessing_dispatch():
    """The fused embed takes 224² uint8 images with every preprocessing step
    on; any other input goes the unfused way, as in the JAX module."""
    _, _, fused = _backbones("cls", fuse_preprocessing=True)
    plain = tvit.ViTBackbone(fused.cfg, variant="cls")
    plain.load_state_dict(fused.state_dict())
    rng = np.random.default_rng(5)
    calls = []
    real = fused._fused_embed
    fused._fused_embed = lambda x: calls.append(tuple(x.shape)) or real(x)
    with torch.no_grad():
        for shape, kw in [((1, 320, 320, 3), {}), ((1, 224, 224, 3), dict(do_resize=False)),
                          ((1, 224, 224, 3), dict(do_normalize=False))]:
            x = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8))
            assert torch.equal(fused(x, **kw), plain(x, **kw)), (shape, kw)
        assert calls == []
        fused(torch.from_numpy(rng.integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)))
    assert calls == [(1, 224, 224, 3)]
