"""The port's teacher towers against the JAX package's on the same weights.

Every tower is built small (a few layers, narrow widths), its JAX params made
by ``module.init`` and perturbed (so that biases, LayerNorm affines, layer
scales and rel-pos tables are all nonzero), carried across by
``models.convert`` and loaded with ``strict=True``.

Tolerances (float32 throughout):
  - towers on float pixels (``do_preprocess=False``): max |got - want| at
    most 1e-5 of max |want| plus 1e-6 (~1e-6 relative seen: sums in another
    order; the ViT teachers' attention runs the plain flash forward (T = 257)
    or K1's plain version (T = 197) against JAX's einsum);
  - towers on uint8 images through their processors: the same, where the
    resize is the identity (224² into a 224 processor); where it resamples,
    the preprocessing alone is held as ``test_torch_vit`` holds it: equal
    but for values one uint8 step apart, float32 sums in another order
    rounding a .5 tie the other way, at most 0.01% of them for bicubic (as
    there) and 0.2% for bilinear (~0.08% seen at 256²->224: a tenth of the
    first pass's bilinear sums lie within 1e-4 of a tie, none of bicubic's),
    0.1% for bicubic 224²->336 (~0.03% seen: upsampling by 1.5 lands exact
    ties on weights of sixths, which float32 holds inexactly);
  - ``ops/image.py``'s new functions: resize matrices bitwise (the same
    numpy code), resizes atol 1e-5 (matmuls in another order),
    ``interpolate_nearest`` exactly (a gather).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.foundation import depth_anything as jda
from theia_tpu.foundation import llava as jllava
from theia_tpu.foundation import sam as jsam
from theia_tpu.foundation import towers as jtowers
from theia_tpu.foundation import vit as jfvit
from theia_tpu.models import vit as jvit
from theia_tpu.ops import image as jimage
from theia_tpu_torch.foundation import depth_anything as tda
from theia_tpu_torch.foundation import llava as tllava
from theia_tpu_torch.foundation import sam as tsam
from theia_tpu_torch.foundation import towers as ttowers
from theia_tpu_torch.foundation import vit as tfvit
from theia_tpu_torch.models import convert
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.ops import image as timage

SMALL = dict(hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128, patch_size=16, image_size=224)
F32_REL = 1e-5


def init(module, seed: int, side: int) -> dict:
    """``module.init`` under ``jax.jit`` (eager init dispatches op by op)."""
    return jax.jit(module.init)(jax.random.PRNGKey(seed), jnp.zeros((1, side, side, 3), jnp.uint8))["params"]


def apply(module, params, x, **kw):
    """``module.apply`` under ``jax.jit``, static keywords closed over."""
    return jax.jit(lambda p, x: module.apply({"params": p}, x, **kw))(params, jnp.asarray(x))


def perturb(params, seed: int, scale: float = 0.05):
    """Every leaf plus seeded noise (numpy), so no weight is left at 0 or 1."""
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)), params)


def assert_close(got, want, rel=F32_REL):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= rel * np.abs(want).max() + 1e-6, (err, np.abs(want).max())


def uint8_images(n: int, side: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, side, side, 3), dtype=np.uint8)


def pixels(n: int, side: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((n, 3, side, side), dtype=np.float32) * 0.5


def clip_pair(cfg, seed=0):
    jm = jtowers.CLIPVisionTower(cfg)
    params = perturb(init(jm, seed, cfg.image_size), seed)
    tm = ttowers.build_tower(ttowers.CLIPVisionTower, cfg, torch.float32, "cpu", convert.clip_vision_state_dict(params))
    return jm, params, tm


def dinov2_pair(cfg, seed=1):
    jm = jtowers.Dinov2Tower(cfg)
    params = perturb(init(jm, seed, 224), seed)
    tm = ttowers.build_tower(ttowers.Dinov2Tower, cfg, torch.float32, "cpu", convert.dinov2_state_dict(params))
    return jm, params, tm


def sam_pair(window_size=4, global_idx=(1, 3), image_size=128, seed=2):
    cfg = jsam.SamVisionConfig(hidden_size=32, num_layers=4, num_heads=2, mlp_dim=64, image_size=image_size,
                               patch_size=16, window_size=window_size, global_attn_indexes=tuple(global_idx),
                               output_channels=8)
    jm = jsam.SamVisionEncoder(cfg)
    params = perturb(init(jm, seed, image_size), seed)
    tcfg = tsam.SamVisionConfig(**dataclasses.asdict(cfg))
    tm = tsam.get_sam_model(state_dict=convert.sam_vision_state_dict(params), device="cpu", cfg=tcfg)
    return jm, params, tm


def depth_cfg(image_size=126):
    backbone = jtowers.TowerConfig(
        hidden_size=32, num_layers=4, num_heads=2, intermediate_size=64, patch_size=14, image_size=image_size,
        layer_norm_eps=1e-6, resize_size=image_size, crop_size=image_size,
        image_mean=jtowers.IMAGENET_MEAN, image_std=jtowers.IMAGENET_STD)
    return dict(backbone=backbone, backbone_stage_indices=(1, 2, 3, 4), reassemble_hidden_size=32,
                neck_hidden_sizes=(8, 16, 32, 32), fusion_hidden_size=16, head_hidden_size=8)


def depth_pair(image_size=126, seed=3):
    kw = depth_cfg(image_size)
    jm = jda.DepthAnything(jda.DepthAnythingConfig(**kw))
    params = perturb(init(jm, seed, image_size), seed)
    tkw = dict(kw, backbone=ttowers.TowerConfig(**dataclasses.asdict(kw["backbone"])))
    tm = tda.get_depth_anything_model(state_dict=convert.depth_anything_state_dict(params), device="cpu",
                                      cfg=tda.DepthAnythingConfig(**tkw))
    return jm, params, tm


def vit_teacher_pair(jcfg, resample, seed=4):
    jm = jfvit._ViTTeacher(jcfg, variant="cls", resample=resample) if resample else jvit.ViTBackbone(jcfg)
    params = perturb(init(jm, seed, 224), seed, scale=0.02)
    tcfg = tvit.ViTBackboneConfig(**{**dataclasses.asdict(jcfg), "attention_impl": "pallas"})
    with torch.device("cpu"):
        tm = tfvit._ViTTeacher(tcfg, resample=resample) if resample else tvit.ViTBackbone(tcfg)
    tm.model.load_state_dict(convert.vit_teacher_state_dict(params), strict=True)
    return jm, params, tm.eval()


# ---- ops/image.py ----


@pytest.mark.parametrize("args", [
    (224, 224, -0.5, None, True, "linear", False),
    (256, 224, -0.5, None, True, "linear", False),  # ViT-H's bilinear downscale
    (224, 1024, -0.5, None, True, "linear", False),  # SAM's upscale
    (19, 37, -0.5, None, False, "linear", True),  # Depth-Anything's fusion resizes
    (37, 74, -0.5, None, False, "linear", False),
    (296, 518, -0.5, None, False, "linear", True),
    (224, 256, -0.5, None, True, "cubic", False),
])
def test_resize_matrices_bitwise(args):
    np.testing.assert_array_equal(timage._resize_matrix(*args), jimage._resize_matrix(*args))


@pytest.mark.parametrize("kernel, align_corners, antialias, hw", [
    ("linear", False, True, (48, 40)), ("linear", True, False, (50, 70)), ("linear", False, False, (50, 70)),
    ("cubic", False, True, (20, 24)),
])
def test_bicubic_resize_kernels_match_jax(kernel, align_corners, antialias, hw):
    x = np.random.default_rng(5).standard_normal((2, 32, 36, 3), dtype=np.float32)
    kw = dict(kernel=kernel, align_corners=align_corners, antialias=antialias)
    want = np.asarray(jimage.bicubic_resize(jnp.asarray(x), *hw, **kw))
    np.testing.assert_allclose(timage.bicubic_resize(torch.from_numpy(x), *hw, **kw).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (32, 24), (7, 9), (64, 64)])
def test_interpolate_matches_jax(hw):
    x = np.random.default_rng(6).standard_normal((2, 16, 20, 5), dtype=np.float32)
    want = np.asarray(jimage.interpolate_nearest(jnp.asarray(x), *hw))
    np.testing.assert_array_equal(timage.interpolate_nearest(torch.from_numpy(x), *hw).numpy(), want)
    want = np.asarray(jimage.interpolate_bilinear(jnp.asarray(x), *hw))
    np.testing.assert_allclose(timage.interpolate_bilinear(torch.from_numpy(x), *hw).numpy(), want, atol=1e-5)


@pytest.mark.parametrize("resample, hw, size, flip_share", [
    ("linear", (256, 256), 224, 2e-3), ("linear", (200, 240), 224, 2e-3), ("linear", (224, 224), 224, 0.0),
    ("cubic", (240, 320), 224, 1e-4),
    # the teachers' processors on 224² shards: SAM's bilinear 1024, LLaVA's bicubic 336, Depth-Anything's 518
    ("linear", (224, 224), 1024, 1e-4), ("cubic", (224, 224), 336, 1e-3), ("cubic", (224, 224), 518, 1e-4)])
def test_preprocess_resample_matches_jax(resample, hw, size, flip_share):
    imgs = np.random.default_rng(7).integers(0, 256, (2, *hw, 3), dtype=np.uint8)
    kw = dict(resize_size=size, crop_size=size, resample=resample)
    want = np.asarray(jimage.preprocess_images(jnp.asarray(imgs), **kw))
    got = timage.preprocess_images(torch.from_numpy(imgs), **kw).numpy()
    diff = np.abs(got - want)
    flipped = diff > 1e-6
    np.testing.assert_allclose(diff[flipped], 1 / 127.5, atol=1e-5)
    assert got.shape == want.shape == (2, size, size, 3)
    assert flipped.mean() <= flip_share, f"{flipped.sum()} of {flipped.size} elements flipped"


def test_student_preprocessing_unchanged():
    """The student's default preprocessing is the computation it was before
    ``resample`` existed, bit for bit: the five-argument bicubic matrices,
    the PIL-rounded passes (W first), the crop, rescale and normalisation;
    the device matrices it caches are those matrices."""
    timage._resize_matrix_on.cache_clear()
    imgs = np.random.default_rng(8).integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
    got = timage.preprocess_images(torch.from_numpy(imgs))
    mh, mw = (torch.from_numpy(timage._resize_matrix(n, 256, -0.5, None, True)) for n in (240, 320))
    y = torch.from_numpy(imgs).permute(0, 3, 1, 2).float()
    y = torch.matmul(y, mw.T).round_().clamp_(0.0, 255.0)
    y = torch.matmul(mh, y).round_().clamp_(0.0, 255.0)[:, :, 16:240, 16:240]
    want = ((y * (1.0 / 255.0) - 0.5) / 0.5).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    cached = {tuple(m.shape): m for m in (timage._resize_matrix_on(n, 256, -0.5, None, True, torch.device("cpu"),
                                                                   torch.float32, "cubic") for n in (240, 320))}
    assert torch.equal(cached[(256, 240)], mh) and torch.equal(cached[(256, 320)], mw)
    assert timage._resize_matrix_on.cache_info().currsize == 2


# ---- towers ----


def test_clip_tower_matches_jax():
    cfg = jtowers.TowerConfig(**SMALL)
    jm, params, tm = clip_pair(cfg)
    x = pixels(2, 224, 10)
    want_tokens, want_pooled = apply(jm, params, x, do_preprocess=False)
    with torch.no_grad():
        tokens, pooled = tm(torch.from_numpy(x), do_preprocess=False)
    assert_close(tokens, want_tokens)
    assert_close(pooled, want_pooled)
    # uint8 224² through the 224 processor (an identity resize), and the feature getter's layout
    from theia_tpu.foundation.clip import get_clip_feature as jget
    from theia_tpu_torch.foundation.clip import get_clip_feature as tget

    imgs = uint8_images(2, 224, 11)
    want = jax.jit(lambda p, x: jget(jm, p, x))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = tget(tm, torch.from_numpy(imgs))
    assert [tuple(g.shape) for g in got] == [(2, 1, 64), (2, 64, 14, 14), (2, 1, 64)]
    for g, w in zip(got, want):
        assert_close(g, w)


def test_dinov2_tower_matches_jax_with_hidden_indices():
    cfg = jtowers.TowerConfig(**SMALL, layer_norm_eps=1e-6, resize_size=256, image_mean=jtowers.IMAGENET_MEAN,
                              image_std=jtowers.IMAGENET_STD)
    jm, params, tm = dinov2_pair(cfg)
    x = pixels(2, 224, 12)
    want = apply(jm, params, x, do_preprocess=False, output_hidden_indices=(0, 1, 2))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), do_preprocess=False, output_hidden_indices=(0, 1, 2))
    assert_close(got[0], want[0])
    assert_close(got[1], want[1])
    assert len(got[2]) == 3
    for g, w in zip(got[2], want[2]):
        assert_close(g, w)


def test_llava_tower_matches_jax(monkeypatch):
    tiny = dataclasses.replace(jllava.LLAVA_VISION, hidden_size=32, num_layers=3, num_heads=2, intermediate_size=64)
    jm, params, tm = clip_pair(tiny, seed=5)
    imgs = uint8_images(2, 336, 13)  # 336² into the 336 processor: an identity resize
    want = jax.jit(lambda p, x: jllava.get_llava_visual_feature(jm, p, x))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = tllava.get_llava_visual_feature(tm, torch.from_numpy(imgs))
    assert tuple(got.shape) == (2, 32, 24, 24)
    assert_close(got, want)
    # a full LlavaForConditionalGeneration state dict loads through its prefixes, the rest dropped
    sd = {f"vision_tower.vision_model.{k}": v for k, v in convert.clip_vision_state_dict(params).items()}
    sd["multi_modal_projector.linear_1.weight"] = torch.zeros(1)
    monkeypatch.setattr(tllava, "LLAVA_VISION", tm.cfg)
    loaded = tllava.get_llava_vision_model(state_dict=sd, device="cpu")
    assert loaded.state_dict().keys() == tm.state_dict().keys()
    assert all(torch.equal(a, b) for a, b in zip(loaded.state_dict().values(), tm.state_dict().values()))


def test_vit_h_teacher_bilinear_matches_jax():
    """ViT-H's geometry (patch 14 at 224: T = 257; heads of 80), cut to 2
    layers of width 160: the port runs the plain flash forward (K7's CPU
    version), JAX its einsum."""
    jcfg = dataclasses.replace(jfvit.VIT_HUGE, hidden_size=160, num_layers=2, num_heads=2, intermediate_size=320)
    jm, params, tm = vit_teacher_pair(jcfg, "linear")
    imgs = uint8_images(2, 224, 14)  # 224² into ViT-H's 224 bilinear processor: an identity resize
    want = jax.jit(lambda p, x: jfvit.get_vit_feature(jm, p, x))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = tfvit.get_vit_feature(tm, torch.from_numpy(imgs))
    assert tuple(got[0].shape) == (2, 160) and tuple(got[1].shape) == (2, 160, 16, 16)
    for g, w in zip(got, want):
        assert_close(g, w)


@pytest.mark.parametrize("name", sorted(jfvit.DEIT_TEACHERS))
def test_deit_teachers_match_jax(name):
    """Each DeiT teacher at its full width, cut to 2 layers, on pixels (its
    processor is the student's, held in ``test_torch_vit``)."""
    jcfg = dataclasses.replace(jfvit.DEIT_TEACHERS[name], num_layers=2)
    jm, params, tm = vit_teacher_pair(jcfg, None)
    x = pixels(2, 224, 15).transpose(0, 2, 3, 1)
    flags = dict(do_resize=False, do_rescale=False, do_normalize=False)
    want = apply(jm, params, x, **flags)
    with torch.no_grad():
        got = tm(torch.from_numpy(np.ascontiguousarray(x)), **flags)
    assert_close(got, want)
    assert tuple(tfvit.get_deit_feature(tm, torch.from_numpy(uint8_images(1, 224, 16))).shape) == (
        1, jcfg.hidden_size, 14, 14)


@pytest.mark.parametrize("window_size, global_idx", [(4, (1, 3)), (3, (2,))])
def test_sam_encoder_matches_jax(window_size, global_idx):
    """window 3 on an 8x8 grid pads it to 9x9 (as tests/test_sam.py)."""
    jm, params, tm = sam_pair(window_size, global_idx)
    x = pixels(2, 128, 17)
    want = apply(jm, params, x, do_preprocess=False)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), do_preprocess=False)
    assert tuple(got.shape) == (2, 8, 8, 8)
    assert_close(got, want)


def test_sam_query_blocks_are_the_same_function():
    """The global layers' plain attention (``ops/attention.py``
    ``relpos_attention_plain``) in blocks of query rows equals one block."""
    from theia_tpu_torch.ops.attention import relpos_attention_plain

    rng = np.random.default_rng(18)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, 32), dtype=np.float32)) for _ in range(3))
    rh, rw = (torch.from_numpy(rng.standard_normal((15, 16), dtype=np.float32)) for _ in range(2))
    whole = relpos_attention_plain(q, k, v, rh, rw, 2, 8, 8, torch.float32)
    for block_bytes in (1, 2 * 2 * 64 * 4 * 5, 2 * 2 * 64 * 4 * 64):  # 1, 5 and 64 rows a block
        torch.testing.assert_close(relpos_attention_plain(q, k, v, rh, rw, 2, 8, 8, torch.float32, block_bytes),
                                   whole, atol=1e-6, rtol=0)


def test_sam_processor_path_matches_jax():
    """uint8 128² into the 128 processor (an identity resize), through
    ``get_sam_feature``."""
    jm, params, tm = sam_pair()
    imgs = uint8_images(1, 128, 19)
    want, _ = jax.jit(lambda p, x: jsam.get_sam_feature(jm, p, x))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got, none = tsam.get_sam_feature(tm, torch.from_numpy(imgs))
    assert none is None
    assert_close(got, want)


def test_depth_anything_matches_jax():
    jm, params, tm = depth_pair()
    x = pixels(2, 126, 20)
    want_depth = apply(jm, params, x, do_preprocess=False)
    want_head = apply(jm, params, x, do_preprocess=False, method=jm.head_feature)
    with torch.no_grad():
        depth = tm(torch.from_numpy(x), do_preprocess=False)
        head = tm.head_feature(torch.from_numpy(x), do_preprocess=False)
    assert tuple(depth.shape) == (2, 126, 126) and tuple(head.shape) == (2, 126, 126, 8)
    assert_close(depth, want_depth)
    assert_close(head, want_head)
    imgs = uint8_images(1, 126, 21)  # 126² into the 126 processor: an identity resize
    want = jax.jit(lambda p, x: jda.get_depth_anything_feature(jm, p, x))(params, jnp.asarray(imgs))
    with torch.no_grad():
        got = tda.get_depth_anything_feature(tm, torch.from_numpy(imgs))
    assert_close(got, want)
