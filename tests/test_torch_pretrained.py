"""Loading a trained student into the port (theia_tpu_torch/models/pretrained.py,
models/hub.py ``from_pretrained``) against the JAX package's loader
(theia_tpu/models/pretrained.py, models/hub.py) on the same files.

The files are written by the JAX package's ``export_theia_checkpoint`` (a
reference RobotVisionFM state dict) as ``.pth`` and ``.safetensors``, and by
the port's own ``train_from_config``. Tolerances: forward_feature and the
teachers' predictions within the serving tests' atol 1e-3 against JAX
(tests/test_torch_serving.py); bit for bit where both sides are the port.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from theia_tpu.data.synthetic import generate_synthetic_dataset
from theia_tpu.data.webdataset import save_safetensors_np
from theia_tpu.models import hub as jhub
from theia_tpu.models import pretrained as jpre
from theia_tpu.models import vit as jvit
from theia_tpu.models.hf_convert import export_theia_checkpoint
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu_torch.config import load_config
from theia_tpu_torch.models import hub as thub
from theia_tpu_torch.models import pretrained as tpre
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.models.rvfm import Theia as TTheia
from theia_tpu_torch.train import loop as tloop

TINY = "facebook/deit-tiny-patch16-224"
VARIANTS = {"cls": TINY, "nocls": f"nocls-{TINY}", "reg": f"reg-{TINY}"}
NAME = "theaiinstitute/theia-tiny-patch16-224-cdiv"
DINO = {"facebook/dinov2-large": (1024, 16, 16)}
CLIP = {"openai/clip-vit-large-patch14": (1024, 16, 16)}
ATOL = 1e-3


@pytest.fixture(scope="module", autouse=True)
def two_layer_backbones():
    saved = [(configs, name, configs[name]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)
             for name in VARIANTS.values()]
    for configs, name, cfg in saved:
        configs[name] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, name, cfg in saved:
        configs[name] = cfg


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _images(n=2, seed=0):
    return np.random.RandomState(seed).randint(0, 256, (n, 224, 224, 3), np.uint8)


def _jax_model(backbone, sizes):
    return JTheia(backbone=backbone, translator="lconv", target_feature_sizes=sizes)


def _jax_params(backbone, sizes, seed=0):
    return _jax_model(backbone, sizes).init(jax.random.PRNGKey(seed), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]


def _port_model(backbone, sizes, seed=1):
    model = TTheia(backbone=backbone, translator="lconv", target_feature_sizes=sizes)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.eval()


def _write(sd, path):
    """A reference state dict as a .pth (torch.save) or .safetensors file."""
    if str(path).endswith(".safetensors"):
        path.write_bytes(save_safetensors_np({k: np.ascontiguousarray(v) for k, v in sd.items()}))
    else:
        torch.save({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, path)
    return str(path)


def _jax_outputs(model, params, images):
    feat = model.apply({"params": params}, jnp.asarray(images), method=model.forward_feature)
    preds = model.apply({"params": params}, jnp.asarray(images))
    return np.asarray(feat), {k: np.asarray(v) for k, v in preds.items()}


def _port_outputs(model, images):
    with torch.no_grad():
        x = torch.from_numpy(images)
        return model.forward_feature(x).numpy(), {k: v.numpy() for k, v in model(x).items()}


def _assert_close(got, want, atol=ATOL):
    gfeat, gpreds = got
    wfeat, wpreds = want
    np.testing.assert_allclose(gfeat, wfeat, atol=atol, rtol=0)
    assert set(gpreds) == set(wpreds)
    for k in wpreds:
        np.testing.assert_allclose(gpreds[k], wpreds[k], atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
def test_from_pretrained_reference_file_matches_jax(tmp_path, suffix):
    """The published entry point in both packages on one exported file (cls, cdiv)."""
    _, teachers = jhub.parse_model_name(NAME)
    sizes = {t: tuple(jhub.get_model_feature_size(t, keep_spatial=True)) for t in teachers}
    path = _write(export_theia_checkpoint(_jax_params(TINY, sizes), sizes), tmp_path / f"model{suffix}")
    images = _images()
    jmodel = jhub.from_pretrained(NAME, path)
    want = (np.asarray(jmodel.forward_feature(images)), {k: np.asarray(v) for k, v in jmodel(images).items()})
    tmodel = thub.from_pretrained(NAME, checkpoint_path=path, device="cpu")
    assert isinstance(tmodel, thub.PretrainedTheia) and next(tmodel.parameters()).device.type == "cpu"
    _assert_close(_port_outputs(tmodel, images), want)
    # the wrapper's reduce method, changed after loading, as the JAX wrapper's
    jmodel.feature_reduce_method = tmodel.feature_reduce_method = "mean_pooling"
    with torch.no_grad():
        got = tmodel.forward_feature(torch.from_numpy(images)).numpy()
    assert got.shape == (2, 192)
    np.testing.assert_allclose(got, np.asarray(jmodel.forward_feature(images)), atol=ATOL, rtol=0)


@pytest.mark.parametrize("suffix", [".pth", ".safetensors"])
@pytest.mark.parametrize("variant", ["cls", "nocls", "reg"])
def test_load_reference_file_matches_jax(tmp_path, variant, suffix):
    backbone = VARIANTS[variant]
    params = _jax_params(backbone, DINO)
    path = _write(export_theia_checkpoint(params, DINO, variant=variant), tmp_path / f"model{suffix}")
    jmodel = _jax_model(backbone, DINO)
    want = _jax_outputs(jmodel, jpre.load_theia_checkpoint(path, jmodel), _images())
    tmodel = tpre.load_theia_checkpoint(path, _port_model(backbone, DINO))
    _assert_close(_port_outputs(tmodel, _images()), want)


def test_missing_teacher_raises_in_both(tmp_path):
    path = _write(export_theia_checkpoint(_jax_params(TINY, DINO), DINO), tmp_path / "model.pth")
    both = {**DINO, **CLIP}
    with pytest.raises(KeyError, match="does not look like a reference RobotVisionFM state dict"):
        jpre.load_theia_checkpoint(path, _jax_model(TINY, both))
    with pytest.raises(KeyError, match="does not look like a reference RobotVisionFM state dict"):
        tpre.load_theia_checkpoint(path, _port_model(TINY, both))


def test_missing_backbone_tensor_raises_in_both(tmp_path):
    sd = export_theia_checkpoint(_jax_params(TINY, DINO), DINO)
    del sd["backbone.model.encoder.layer.1.output.dense.bias"]
    path = _write(sd, tmp_path / "model.safetensors")
    with pytest.raises(KeyError, match="does not look like"):
        jpre.load_theia_checkpoint(path, _jax_model(TINY, DINO))
    with pytest.raises(KeyError, match="layer.1.output.dense.bias"):
        tpre.load_theia_checkpoint(path, _port_model(TINY, DINO))


def test_extra_teacher_is_ignored_in_both(tmp_path):
    both = {**DINO, **CLIP}
    params = _jax_params(TINY, both)
    path = _write(export_theia_checkpoint(params, both), tmp_path / "model.pth")
    jmodel = _jax_model(TINY, DINO)
    want = _jax_outputs(jmodel, jpre.load_theia_checkpoint(path, jmodel), _images())
    got = _port_outputs(tpre.load_theia_checkpoint(path, _port_model(TINY, DINO)), _images())
    assert set(got[1]) == set(DINO)
    _assert_close(got, want)


def test_shape_mismatch_keeps_init_and_casts_in_both(tmp_path):
    """A tensor of another shape keeps the model's initial value in both
    loaders; the rest loads, cast from the file's float64 to float32."""
    sd = {k: np.asarray(v, np.float64) for k, v in export_theia_checkpoint(_jax_params(TINY, DINO), DINO).items()}
    query = "backbone.model.encoder.layer.0.attention.attention.query.weight"
    sd[query] = np.ones((10, 10))
    path = _write(sd, tmp_path / "model.pth")

    jmodel = _jax_model(TINY, DINO)
    init = _jax_params(TINY, DINO, seed=5)
    loaded = jpre.load_theia_checkpoint(path, jmodel, init_params=init)
    np.testing.assert_array_equal(loaded["backbone_module"]["block_0"]["query"]["kernel"],
                                  init["backbone_module"]["block_0"]["query"]["kernel"])
    key = "backbone.model.encoder.layer.0.attention.attention.key.weight"
    np.testing.assert_array_equal(np.asarray(loaded["backbone_module"]["block_0"]["key"]["kernel"]).T,
                                  sd[key].astype(np.float32))

    tmodel = _port_model(TINY, DINO)
    before = {n: t.clone() for n, t in tmodel.state_dict().items()}
    tpre.load_theia_checkpoint(path, tmodel)
    after = tmodel.state_dict()
    assert torch.equal(after[query], before[query])
    assert after[key].dtype == torch.float32
    assert torch.equal(after[key], torch.from_numpy(sd[key]).float())
    differ = [n for n in after if n != query and not torch.equal(after[n], torch.from_numpy(sd[n]).float())]
    assert not differ


def test_checkpoint_path_none_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        thub.from_pretrained(NAME, device="cpu")
    with pytest.raises(FileNotFoundError, match="no committed checkpoint step"):
        tpre.load_theia_checkpoint(str(tmp_path), _port_model(TINY, DINO))


# a 16x16 and a 64x64 head; square ladder convs, whose weights the JAX
# converter's other reading keeps the shape of: conv's adapter.4 and .7 at
# 16x16 (hidden 8: 8 -> 16 -> 16 -> 16), lconv's adapter.1 and .4 at 64x64
# (192 -> 192 -> 192)
PADLESS = {"conv": ({"translator_hidden_size": 8}, {"teacher/a": (16, 16, 16), "teacher/b": (12, 64, 64)}),
           "lconv": ({}, {"teacher/a": (16, 16, 16), "teacher/b": (12, 64, 64)})}


@pytest.mark.parametrize("translator", list(PADLESS))
def test_head_without_its_pad_loads_as_the_jax_loader(tmp_path, translator):
    """A translator's state dict with every head's ``pad.1.*`` dropped: the
    JAX converter reads the heads on the 14x14 grid (conv: the 16x16
    ladder as ConvTranspose2d; lconv: the 16 -> 64 ladder as Conv2d) and
    keeps its init where a shape then differs. From the same initial
    parameters (the JAX loader's ``PRNGKey(0)`` init), the port's loaded
    state dict equals ``state_dict_from_jax`` of the JAX loader's params."""
    kwargs, sizes = PADLESS[translator]

    def jax_model():
        return JTheia(backbone=TINY, translator=translator, target_feature_sizes=sizes, translator_kwargs=kwargs)

    def carried(params):
        return state_dict_from_jax(jax.tree.map(np.asarray, params), sizes, translator=translator)

    zeros = jnp.zeros((1, 224, 224, 3), jnp.uint8)
    sd = {k: v for k, v in carried(jax_model().init(jax.random.PRNGKey(5), zeros)["params"]).items()
          if ".pad.1." not in k}
    path = str(tmp_path / "nopad.pth")
    torch.save(sd, path)
    want = carried(jpre.load_theia_checkpoint(path, jax_model()))
    model = TTheia(backbone=TINY, translator=translator, target_feature_sizes=sizes, translator_kwargs=kwargs)
    model.load_state_dict(carried(jax_model().init(jax.random.PRNGKey(0), zeros)["params"]), strict=True)
    tpre.load_theia_checkpoint(path, model)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    swapped = [k for k in sd if sd[k].dim() == 4 and not torch.equal(got[k], sd[k])
               and torch.equal(got[k], sd[k].transpose(0, 1))]
    assert [k.split(".", 3)[3] for k in swapped] == {
        "conv": ["adapter.4.weight", "adapter.7.weight"], "lconv": ["adapter.1.weight", "adapter.4.weight"]}[translator]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A port checkpoint directory: 2 exact-mode steps of Theia-tiny (2
    layers) cdiv on the CPU, a save at each step."""
    _, teachers = jhub.parse_model_name(NAME)
    sizes = {t: tuple(jhub.get_model_feature_size(t, keep_spatial=True)) for t in teachers}
    root = tmp_path_factory.mktemp("trained")
    generate_synthetic_dataset(str(root / "data"), feature_models=sizes, n_train=4, n_val=2, samples_per_shard=4)
    cfg = load_config("train_rvfm_imagenet", [
        "model/backbone=deit_tiny", "training/target_models=cdiv", f"dataset.dataset_root={root}/data",
        "dataset.dataset_ratio=1.0", "dataset.shuffle_buffer_size=2", "training.epochs=1", "training.batch_size=2",
        "training.compute_dtype=float32", "training.fast_math=false", "training.fuse_preprocessing=false",
        f"logging.model_path={root}/ckpt", f"logging.log_path={root}/logs", "logging.save_ckpt_interval=1"])
    summary = tloop.train_from_config(cfg, resume=False, device="cpu")
    assert summary["step"] == 2
    return summary["ckpt_dir"]


def _copied(params):
    """The model ``from_pretrained`` builds, the trained params copied in directly."""
    model = thub.build_theia(NAME, device="cpu", generator=torch.Generator().manual_seed(9))
    model.load_state_dict(params, strict=True)
    return model


def _assert_bit_equal(got, want):
    gfeat, gpreds = got
    wfeat, wpreds = want
    np.testing.assert_array_equal(gfeat, wfeat)
    for k in wpreds:
        np.testing.assert_array_equal(gpreds[k], wpreds[k], err_msg=k)


def test_port_checkpoint_directory_and_step_file_load(trained):
    images = _images(3, seed=4)
    params = torch.load(os.path.join(trained, "2.pt"), weights_only=True)["params"]
    want = _port_outputs(_copied(params), images)
    for path in (trained, os.path.join(trained, "2.pt")):
        model = thub.from_pretrained(NAME, checkpoint_path=path, device="cpu")
        _assert_bit_equal(_port_outputs(model, images), want)
    fresh = _port_outputs(thub.build_theia(NAME, device="cpu", generator=torch.Generator().manual_seed(0)), images)
    assert not np.array_equal(fresh[0], want[0])


def test_port_checkpoint_directory_falls_back_past_a_corrupt_step(trained, tmp_path):
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for step in (1, 2):
        (ckpt / f"{step}.pt").write_bytes((open(os.path.join(trained, f"{step}.pt"), "rb")).read())
    (ckpt / "2.pt").write_bytes((ckpt / "2.pt").read_bytes()[:1000])
    params = torch.load(ckpt / "1.pt", weights_only=True)["params"]
    images = _images(2, seed=6)
    with pytest.warns(UserWarning, match="step 2"):
        model = thub.from_pretrained(NAME, checkpoint_path=str(ckpt), device="cpu")
    _assert_bit_equal(_port_outputs(model, images), _port_outputs(_copied(params), images))
