"""The port's decoding path (theia_tpu_torch/decoding/, foundation/sam_decoder.py,
scripts/decoding_example.py) against the JAX package's on the CPU.

Tolerances: the SAM mask decoder's masks and IoU atol 1e-4 (float32, the
same math, sums in another order); the AMG helpers equal; decode_dinov2
given the same sklearn PCA atol 1e-5, the port's own fit against sklearn's
``svd_solver="full"`` components atol 1e-4 after sklearn's sign rule;
decode_depth_anything atol 1e-5; decode_everything with the same seeded
``np.random``: the same number of masks kept, panels atol 1e-4 except at
pixels where an upscaled mask logit lies within 1e-4 of the threshold.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import theia_tpu.foundation.extraction as jextraction
from theia_tpu.decoding import amg as jamg
from theia_tpu.decoding import decode_everything as jdecode_everything
from theia_tpu.decoding.depth_anything import decode_depth_anything as jdecode_depth
from theia_tpu.decoding.dinov2 import decode_dinov2 as jdecode_dinov2
from theia_tpu.decoding.sam import prepare_mask_generator as jprepare_mask_generator
from theia_tpu.foundation.sam_decoder import SamDecoderConfig as JConfig
from theia_tpu.foundation.sam_decoder import SamMaskDecoder as JDecoder
from theia_tpu.foundation.sam_decoder import convert_sam_decoder
from theia_tpu_torch.decoding import amg as tamg
from theia_tpu_torch.decoding import decode_everything, prepare_depth_decoder, prepare_mask_generator
from theia_tpu_torch.decoding.depth_anything import decode_depth_anything
from theia_tpu_torch.decoding.dinov2 import PCA, decode_dinov2
from theia_tpu_torch.foundation import extraction as textraction
from theia_tpu_torch.foundation.sam_decoder import SamDecoderConfig, build_sam_decoder
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import sam_decoder_state_dict

SMALL = dict(hidden_size=16, num_heads=2, mlp_dim=32, iou_head_hidden_dim=16, image_embedding_size=8,
             input_image_size=128, num_pos_feats=8)
DINO, SAM, DEPTH = "facebook/dinov2-large", "facebook/sam-vit-huge", "LiheYoung/depth-anything-large-hf"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _small_pair(seed=0):
    jm = JDecoder(JConfig(**SMALL))
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, 16)), jnp.zeros((1, 1, 1, 2)),
                     jnp.ones((1, 1, 1), jnp.int32))["params"]
    tm = build_sam_decoder(sam_decoder_state_dict(params, SamDecoderConfig(**SMALL)), SamDecoderConfig(**SMALL),
                           device="cpu")
    return jm, params, tm


@pytest.mark.parametrize("multimask", [True, False])
def test_sam_decoder_matches_jax(multimask):
    jm, params, tm = _small_pair()
    rng = np.random.RandomState(0)
    emb = rng.randn(2, 8, 8, 16).astype(np.float32)
    points = (rng.rand(2, 3, 2, 2) * 128).astype(np.float32)  # [B, P, N, 2]
    labels = np.ones((2, 3, 2), np.int32)
    labels[0, 0, 1] = 0
    want_m, want_i = jm.apply({"params": params}, jnp.asarray(emb), jnp.asarray(points), jnp.asarray(labels),
                              multimask_output=multimask)
    with torch.no_grad():
        got_m, got_i = tm(torch.from_numpy(emb), torch.from_numpy(points), torch.from_numpy(labels), multimask)
    assert tuple(got_m.shape) == want_m.shape == (2, 3, 3 if multimask else 1, 32, 32)
    np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m), atol=1e-4, rtol=0)
    np.testing.assert_allclose(got_i.numpy(), np.asarray(want_i), atol=1e-4, rtol=0)


def test_sam_decoder_carry_across_inverts_convert_sam_decoder():
    """JAX params -> the port's HF-layout state dict -> the JAX package's
    ``convert_sam_decoder`` -> the same params, leaf for leaf; and an HF
    ``SamModel`` state dict loads into the port strictly, with the same names."""
    from transformers import SamConfig, SamModel

    _, params, tm = _small_pair(seed=1)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    back = convert_sam_decoder(sd, JConfig(**SMALL))
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    flat_want = dict(jax.tree_util.tree_leaves_with_path(params))
    assert set(flat_back) == set(flat_want)
    for k, v in flat_want.items():
        np.testing.assert_array_equal(np.asarray(flat_back[k]), np.asarray(v), err_msg=jax.tree_util.keystr(k))
    hf = SamModel(SamConfig(
        vision_config=dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, image_size=128, patch_size=16,
                           window_size=4, global_attn_indexes=[1], mlp_dim=64, output_channels=16, num_pos_feats=8),
        prompt_encoder_config=dict(hidden_size=16, image_size=128, patch_size=16, num_pos_feats=8),
        mask_decoder_config=dict(hidden_size=16, num_attention_heads=2, mlp_dim=32, iou_head_hidden_dim=16)))
    hf_sd = hf.state_dict()
    loaded = build_sam_decoder(hf_sd, SamDecoderConfig(**SMALL), device="cpu")
    assert set(loaded.state_dict()) == {k for k in hf_sd if not k.startswith("vision_encoder.")} == set(sd)


def test_amg_helpers_match_jax():
    rng = np.random.RandomState(3)
    np.testing.assert_array_equal(tamg.build_point_grid(5), jamg.build_point_grid(5))
    coords = rng.rand(7, 2) * 200
    np.testing.assert_array_equal(tamg.normalize_coordinates(1024, coords, (180, 224)),
                                  jamg.normalize_coordinates(1024, coords, (180, 224)))
    for layers in (0, 1, 2):
        got, want = tamg.generate_crop_boxes((224, 200), layers, points_per_crop=8, crop_n_points_downscale_factor=2), \
            jamg.generate_crop_boxes((224, 200), layers, points_per_crop=8, crop_n_points_downscale_factor=2)
        np.testing.assert_array_equal(got[0], want[0])
        for a, b in zip(got[1], want[1]):
            np.testing.assert_array_equal(a, b)

    logits = (rng.randn(9, 40, 36) * 3).astype(np.float32)
    logits[2] = -5.0  # an empty mask
    np.testing.assert_array_equal(tamg.compute_stability_score(torch.from_numpy(logits), 0.0, 1.0).numpy(),
                                  jamg.compute_stability_score(logits, 0.0, 1.0))
    binary = logits > 0.0
    boxes = tamg.batched_mask_to_box(torch.from_numpy(binary)).numpy()
    np.testing.assert_array_equal(boxes, jamg.batched_mask_to_box(binary))
    np.testing.assert_array_equal(tamg.batched_mask_to_box(torch.zeros(0, 4, 4, dtype=torch.bool)).numpy(),
                                  jamg.batched_mask_to_box(np.zeros((0, 4, 4), bool)))
    crop, orig = [10, 20, 46, 60], [0, 0, 100, 90]
    np.testing.assert_array_equal(tamg.is_box_near_crop_edge(torch.from_numpy(boxes), crop, orig).numpy(),
                                  jamg.is_box_near_crop_edge(boxes, crop, orig))
    rles = tamg.mask_to_rle(torch.from_numpy(binary))
    assert rles == jamg.mask_to_rle(binary)
    assert tamg.mask_to_rle(torch.ones(2, 3, 3, dtype=torch.bool)) == jamg.mask_to_rle(np.ones((2, 3, 3), bool))
    for rle, m in zip(rles, binary):
        np.testing.assert_array_equal(tamg.rle_to_mask(rle), jamg.rle_to_mask(rle))
        np.testing.assert_array_equal(tamg.rle_to_mask(rle), m)
    np.testing.assert_array_equal(tamg.pad_mask_to_image(torch.from_numpy(binary), crop, 90, 100).numpy(),
                                  jamg.pad_mask_to_image(binary, crop, 90, 100))

    nms_boxes = np.concatenate([rng.rand(40, 2) * 50, rng.rand(40, 2) * 50 + 30], axis=1)
    nms_boxes[5] = nms_boxes[6]  # a duplicate box
    scores = rng.rand(40).astype(np.float32)
    scores[7] = scores[8]  # a tie
    for thr in (0.0, 0.3, 0.7):
        np.testing.assert_array_equal(tamg.box_nms(nms_boxes, scores, thr), jamg.box_nms(nms_boxes, scores, thr))
    assert len(tamg.box_nms(np.zeros((0, 4)), np.zeros(0), 0.7)) == 0

    iou = rng.rand(9).astype(np.float32)
    for kw in (dict(pred_iou_thresh=0.3, stability_score_thresh=0.2), dict(pred_iou_thresh=0.0,
                                                                           stability_score_thresh=0.0)):
        got = tamg.filter_masks(torch.from_numpy(logits), torch.from_numpy(iou), crop, orig, **kw)
        want = jamg.filter_masks(logits, iou, crop, orig, **kw)
        assert got[0] == want[0]
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("interpolation", [False, True])
def test_decode_dinov2_matches_jax(interpolation):
    from sklearn.decomposition import PCA as SkPCA

    rng = np.random.RandomState(0)
    feats = (rng.randn(2, 256, 64) + np.linspace(-2, 2, 64)[None, None] * rng.randn(2, 256, 1)).astype(np.float32)
    sk = SkPCA(n_components=3, svd_solver="full").fit(feats.reshape(-1, 64))
    want, _ = jdecode_dinov2(feats, interpolation=interpolation, pca=sk)
    got, same = decode_dinov2(feats, interpolation=interpolation, pca=sk, device="cpu")
    assert same is sk and got.shape == want.shape == (2, 224, 224, 3)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # the port's own exact fit: sklearn's full-solver components and sign rule
    own, pca = decode_dinov2(feats, interpolation=interpolation, device="cpu")
    assert isinstance(pca, PCA)
    np.testing.assert_allclose(pca.components_.numpy(), sk.components_, atol=1e-4, rtol=0)
    np.testing.assert_allclose(pca.mean_.numpy(), sk.mean_, atol=1e-5, rtol=0)
    np.testing.assert_allclose(own, want, atol=1e-3, rtol=0)


@pytest.mark.parametrize("offset,spread,seed,sklearn_max", [(4.0, 10.0, 7, "1 + 1.19e-07"),
                                                          (55.0, 0.02, 74, "1 + 3.05e-05")])
def test_decode_dinov2_min_max_in_unit_range(offset, spread, seed, sklearn_max):
    """The min-max lands in [0, 1], equal to its float64 value. With the
    identity as the PCA the projections are the features; at these seeds
    sklearn's x * scale - min * scale gives ``sklearn_max``: one ulp where
    the columns' |min| is about half their span (the predicted row's on the
    card), more where the offset dwarfs the spread."""
    pca = PCA(3)
    pca.mean_, pca.components_ = torch.zeros(3), torch.eye(3)
    feats = (offset + spread * np.random.RandomState(seed).randn(1, 64, 3)).astype(np.float32)
    got, _ = decode_dinov2(feats, pca=pca, device="cpu")
    assert 0.0 <= got.min() and got.max() <= 1.0
    x = feats[0].astype(np.float64)
    want = ((x - x.min(0)) / (x.max(0) - x.min(0))).reshape(8, 8, 3).repeat(28, 0).repeat(28, 1)
    np.testing.assert_allclose(got[0], want, atol=1e-6, rtol=0)


def test_decode_depth_anything_matches_jax():
    rng = np.random.RandomState(1)
    conv, patch = prepare_depth_decoder(device="cpu", generator=torch.Generator().manual_seed(0))
    assert patch == 14 and tuple(conv.weight.shape) == (1, 32, 1, 1)
    with torch.no_grad():
        conv.weight.normal_(0, 0.3, generator=torch.Generator().manual_seed(1))
        conv.bias.fill_(0.05)
    jdecoder = {"conv3_kernel": conv.weight.numpy().transpose(2, 3, 1, 0), "conv3_bias": conv.bias.numpy()}
    feats = rng.randn(2, 4096, 32).astype(np.float32)
    want = jdecode_depth(feats, jdecoder)
    got = decode_depth_anything(feats, conv)
    assert got.shape == want.shape == (2, 224, 224, 3) and 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


SIZES = {DINO: (64, 256), SAM: (256, 4096), DEPTH: (32, 4096)}
GRID = np.sin(np.arange(64 * 16 * 16, dtype=np.float32)).reshape(1, 64, 16, 16)


def _jax_fake_get_model(name, hf_model=None, dtype=jnp.float32):
    """The JAX teachers' stand-ins (tests/test_decoding.py's), real output layouts."""
    if "dinov2" in name:
        fn = lambda m, p, x: (None, jnp.mean(x.astype(jnp.float32), axis=(1, 2, 3), keepdims=True) * 0.01 + GRID, None)
    elif "sam" in name:
        fn = lambda m, p, x: (jnp.mean(x.astype(jnp.float32), axis=(1, 2, 3), keepdims=True) * 0.001
                              + jnp.asarray(SAM_GT), None)
    else:
        fn = lambda m, p, x: jnp.ones((x.shape[0], 32, 518, 518)) * 0.2 + jnp.asarray(DEPTH_GRID)
    return object(), {"seed": 0}, fn


SAM_GT = np.random.RandomState(7).randn(1, 256, 64, 64).astype(np.float32)
DEPTH_GRID = np.cos(np.arange(518 * 518, dtype=np.float32)).reshape(1, 1, 518, 518)


def _port_fake_lookup(name):
    """The same stand-ins for the port's ``run_gt_teachers``."""
    if "dinov2" in name:
        fn = lambda m, x: (None, x.float().mean(dim=(1, 2, 3), keepdim=True) * 0.01 + torch.from_numpy(GRID), None)
    elif "sam" in name:
        fn = lambda m, x: (x.float().mean(dim=(1, 2, 3), keepdim=True) * 0.001 + torch.from_numpy(SAM_GT), None)
    else:
        fn = lambda m, x: torch.ones(x.shape[0], 32, 518, 518) * 0.2 + torch.from_numpy(DEPTH_GRID)
    return None, fn


@pytest.fixture(scope="module")
def generators():
    """The JAX package's mask generator (the full decoder at its PRNGKey(0)
    init) and the port's on the same weights, 4² points each."""
    jgen, _ = jprepare_mask_generator()
    jgen.points_per_side = 4
    tgen, _ = prepare_mask_generator(state_dict=sam_decoder_state_dict(jgen.params), device="cpu", points_per_side=4)
    return jgen, tgen


@pytest.mark.parametrize("gt", [False, True])
def test_decode_everything_matches_jax(monkeypatch, generators, gt):
    from sklearn.decomposition import PCA as SkPCA

    jgen, tgen = generators
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    preds = {k: rng.randn(2, n, c).astype(np.float32) for k, (c, n) in SIZES.items()}
    means = {k: rng.randn(c).astype(np.float32) * 0.1 for k, (c, _) in SIZES.items()}
    stds = {k: (rng.rand(c) + 0.5).astype(np.float32) for k, (c, _) in SIZES.items()}
    conv, _ = prepare_depth_decoder(device="cpu", generator=torch.Generator().manual_seed(2))
    jdepth = {"conv3_kernel": conv.weight.numpy().transpose(2, 3, 1, 0), "conv3_bias": conv.bias.numpy()}

    kept = {"jax": [], "port": []}
    near = torch.zeros(224, 224, dtype=torch.bool)

    def record(cls, key):
        call = cls.__call__

        def wrapped(self, *a, **k):
            out = call(self, *a, **k)
            kept[key].append(len(out["masks"]))
            return out
        monkeypatch.setattr(cls, "__call__", wrapped)

    record(type(jgen), "jax")
    record(type(tgen), "port")
    upscale = tgen._upscale

    def recording_upscale(masks, hw):
        out = upscale(masks, hw)
        near.logical_or_((out.abs() < 1e-4).any(dim=0))
        return out

    monkeypatch.setattr(tgen, "_upscale", recording_upscale)
    # one exact PCA for both (the JAX default lets sklearn pick its randomized solver)
    pca = SkPCA(n_components=3, svd_solver="full").fit(
        (preds[DINO] * stds[DINO] + means[DINO]).reshape(-1, SIZES[DINO][0]))
    kw = dict(pred_iou_thresh=-1.0, stability_score_thresh=0.0, gt=gt, pca=pca)
    if gt:
        monkeypatch.setattr(jextraction, "get_model", _jax_fake_get_model)
        monkeypatch.setattr(textraction, "_lookup", _port_fake_lookup)
    np.random.seed(0)
    want, want_gt = jdecode_everything(lambda x: preds, means, stds, images, jgen, jdepth,
                                       gt_teacher_params={k: {} for k in SIZES} if gt else None, **kw)
    np.random.seed(0)
    got, got_gt = decode_everything(lambda x: preds, means, stds, images, tgen, conv, device="cpu",
                                    gt_teacher_modules={k: nn.Linear(1, 1) for k in SIZES} if gt else None, **kw)
    assert kept["port"] == kept["jax"] and len(kept["jax"]) == (4 if gt else 2) and sum(kept["jax"]) > 0
    assert (got_gt is None) == (want_gt is None) == (not gt)
    sam_cols = np.zeros((224, 896), bool)
    sam_cols[:, 448:672] = near.numpy()
    for g, w in zip(got + (got_gt or []), want + (want_gt or [])):
        assert g.shape == w.shape == (224, 896, 3)
        diff = np.abs(g - w).max(axis=-1)
        assert diff[~sam_cols].max() <= 1e-4, [float(diff[:, i * 224:(i + 1) * 224].max()) for i in range(4)]


def test_decoding_example_main(tmp_path, monkeypatch):
    """``main`` with the media reader and writer replaced: a 2-layer
    deit-tiny student from a reference-layout file, the SAM decoder (on a
    2² point grid) and the depth head at a seeded init (an empty HF cache),
    on the CPU."""
    import theia_tpu_torch.decoding as tdecoding
    from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES
    from theia_tpu_torch.models.rvfm import Theia
    from theia_tpu_torch.scripts import decoding_example

    tiny = "facebook/deit-tiny-patch16-224"
    monkeypatch.setitem(tvit.BACKBONE_CONFIGS, tiny, dataclasses.replace(tvit.BACKBONE_CONFIGS[tiny], num_layers=2))
    teachers = [m for m in MODEL_FEATURE_SIZES if "llava" not in m]
    student = Theia(backbone=tiny, target_feature_sizes={t: MODEL_FEATURE_SIZES[t] for t in teachers})
    student.reset_parameters(torch.Generator().manual_seed(3))
    torch.save(student.state_dict(), tmp_path / "student.pth")
    for t in teachers:
        c = MODEL_FEATURE_SIZES[t][0]
        np.save(tmp_path / f"imagenet_mean_{t.replace('/', '_')}.npy", np.zeros(c, np.float32))
        np.save(tmp_path / f"imagenet_var_{t.replace('/', '_')}.npy", np.ones(c, np.float32))
    frames = np.random.RandomState(4).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    written = {}
    monkeypatch.setattr(decoding_example, "load_media", lambda path: frames)
    monkeypatch.setattr(decoding_example, "write_media",
                        lambda results, out_dir, base: written.update(results=results, base=base) or "x")
    monkeypatch.setenv("HF_HUB_CACHE", str(tmp_path / "hub"))
    # 2² points instead of the generator's 32² (the full SAM decoder on the CPU)
    monkeypatch.setattr(tdecoding, "prepare_mask_generator",
                        lambda **kw: prepare_mask_generator(points_per_side=2, **kw))
    with pytest.warns(UserWarning, match="random init"):
        n = decoding_example.main(["--backbone", tiny, "--checkpoint", str(tmp_path / "student.pth"),
                                   "--media-to-vis-path", str(tmp_path / "clip.mp4"), "--vis-output-dir",
                                   str(tmp_path / "vis"), "--stat-root", str(tmp_path), "--device", "cpu"])
    assert n == 2 and written["base"] == "clip" and len(written["results"]) == 2
    for panel in written["results"]:
        assert panel.shape == (224, 896, 3) and np.isfinite(panel).all()
    with pytest.raises(SystemExit):  # --gt without the teachers' weights is refused before any work
        decoding_example.main(["--checkpoint", "x", "--media-to-vis-path", "y", "--gt", "--device", "cpu"])


def test_decoding_imports_no_sklearn_transformers_or_cv2():
    """The decoding path and the example script load none of them (the
    script's media reader and writer import cv2 only when called)."""
    import json
    import subprocess
    import sys

    code = ("import json, sys\n"
            "import theia_tpu_torch.decoding, theia_tpu_torch.scripts.decoding_example\n"
            "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('sklearn', 'transformers', 'cv2', 'jax', 'theia_tpu'))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sam_decoder_config_equals_the_jax_package():
    want = dataclasses.asdict(JConfig())
    assert {k: v for k, v in dataclasses.asdict(SamDecoderConfig()).items() if k in want} == want
