"""The port's remaining scripts against the JAX package's: verify_published
(its image set, fixture name, the port's model on a seeded Theia-Tiny cdiv
file and the fixture it writes), subsampling_videos (with the video
decoders replaced by the same numpy stand-ins in both) and the two shell
scripts (syntax, and every module and flag they pass)."""

import argparse
import dataclasses
import inspect
import io
import os
import re
import subprocess
import tarfile
from pathlib import Path

import numpy as np
import pytest
import torch

from theia_tpu.models import vit as jvit
from theia_tpu.scripts import subsampling_videos as jsub
from theia_tpu.scripts import verify_published as jvp
from theia_tpu_torch.config import load_config
from theia_tpu_torch.data import webdataset as twds
from theia_tpu_torch.data.synthetic import generate_synthetic_dataset
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.hub import build_theia
from theia_tpu_torch.scripts import subsampling_videos as tsub
from theia_tpu_torch.scripts import verify_published as tvp

NAME = "theaiinstitute/theia-tiny-patch16-224-cdiv"
TINY = "facebook/deit-tiny-patch16-224"
SCRIPTS = Path(tvp.__file__).resolve().parent


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def two_layer_tiny():
    """Theia-Tiny cut to 2 layers in both packages (the widths stay)."""
    saved = [(configs, configs[TINY]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[TINY] = dataclasses.replace(cfg, num_layers=2)
    yield
    for configs, cfg in saved:
        configs[TINY] = cfg


@pytest.fixture(scope="module")
def tiny_checkpoint(two_layer_tiny, tmp_path_factory):
    """A seeded Theia-Tiny cdiv's state_dict as a safetensors file."""
    model = build_theia(NAME, device="cpu", generator=torch.Generator().manual_seed(11))
    path = tmp_path_factory.mktemp("ckpt") / "model.safetensors"
    path.write_bytes(twds.save_safetensors(model.state_dict()))
    return str(path)


def test_images_and_fixture_names_match_jax():
    assert (tvp.IMAGE_SEED, tvp.N_IMAGES, tvp.TOL_MSE) == (jvp.IMAGE_SEED, jvp.N_IMAGES, jvp.TOL_MSE)
    np.testing.assert_array_equal(tvp.fixed_images(), jvp.fixed_images())
    np.testing.assert_array_equal(tvp.fixed_images(2), jvp.fixed_images(2))
    for name in (NAME, "theaiinstitute/theia-base-patch16-224-cddsv", "theia-small-patch16-224", "local"):
        assert tvp.fixture_name(name) == jvp.fixture_name(name)


def test_run_ours_matches_jax(tiny_checkpoint):
    """float32 on the same file: the port on the CPU against the JAX model."""
    images = tvp.fixed_images()
    _, tfeat, tpreds = tvp.run_ours(NAME, tiny_checkpoint, images, device="cpu")
    _, jfeat, jpreds = jvp.run_ours(NAME, tiny_checkpoint, images)
    assert tfeat.shape == jfeat.shape == (4, 196, 192) and tfeat.dtype == np.float32
    np.testing.assert_allclose(tfeat, jfeat, atol=1e-4, rtol=0)
    assert set(tpreds) == set(jpreds) and len(tpreds) == 3
    for k in jpreds:
        np.testing.assert_allclose(tpreds[k], jpreds[k], atol=1e-4, rtol=0, err_msg=k)


def test_main_writes_the_jax_fixture_keys(tiny_checkpoint, tmp_path, monkeypatch):
    argv = ["--model", NAME, "--checkpoint", tiny_checkpoint]
    report = tvp.main([*argv, "--fixture-dir", str(tmp_path / "port"), "--device", "cpu", "--store-params"])
    assert report["reference_ran"] is False and report["parity_ok"] is None
    assert report["kernel_launches"] == {"mha_fwd": 0, "flash_fwd": 0}  # the CPU takes the plain path
    # the JAX runbook on the same file, with its reference legs left out
    monkeypatch.setattr(jvp, "run_reference_torch", lambda *a: None)
    monkeypatch.setattr("sys.argv", ["verify_published", *argv, "--fixture-dir", str(tmp_path / "jax")])
    os.makedirs(tmp_path / "jax")
    jvp.main()
    name = jvp.fixture_name(NAME)
    got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
    params = {k for k in got.files if k.startswith("param::")}
    assert set(got.files) - params == set(want.files)
    np.testing.assert_array_equal(got["images"], want["images"])
    assert str(got["model_name"]) == str(want["model_name"]) == NAME
    for k in want.files:
        if k.startswith("ours::"):
            assert got[k].dtype == want[k].dtype == np.float16
            np.testing.assert_allclose(got[k].astype(np.float32), want[k].astype(np.float32), atol=2e-3, rtol=1e-3,
                                       err_msg=k)
    # --store-params: the port's state_dict in float16, under its own (the reference's) names
    sd = twds.load_safetensors(Path(tiny_checkpoint).read_bytes())
    assert params == {f"param::{k}" for k in sd}
    for k, v in sd.items():
        np.testing.assert_array_equal(got[f"param::{k}"], v.float().numpy().astype(np.float16))


# ---------------------------------------------------------------------------
# subsampling_videos
# ---------------------------------------------------------------------------

def _frames_of(path, count):
    rng = np.random.default_rng(sum(path.encode()))
    return [rng.integers(0, 256, (6, 5, 3), dtype=np.uint8) for _ in range(count)]


def fake_video_frames(path, rate):
    for idx, frame in enumerate(_frames_of(path, 23)):
        if idx % rate == 0:
            yield idx, frame


def fake_jpg_tar_frames(path, rate):
    for idx, frame in enumerate(_frames_of(path, 130)):
        if idx % rate == 0:
            yield idx, frame


def fake_resize(frame, size=224):
    return np.ascontiguousarray(np.resize(frame, (size, size, 3)))


def _shards(out_dir):
    """{shard file: [(member, decoded image)]}; members, not tar bytes, which carry mtimes."""
    shards = {}
    for fn in sorted(os.listdir(out_dir)):
        with tarfile.open(os.path.join(out_dir, fn)) as tar:
            shards[fn] = [(m.name, twds.decode_image_npy(tar.extractfile(m).read()).numpy())
                          for m in tar if m.isfile()]
    return shards


@pytest.mark.parametrize("dataset,ext,rate", [("ego4d", ".mp4", "3"), ("epic_kitchen", ".tar", "-1"),
                                              ("ssv2", ".webm", "5")])
def test_subsampling_main_matches_jax(tmp_path, monkeypatch, dataset, ext, rate):
    assert (tsub.DEFAULT_RATES, tsub.VIDEO_EXT) == (jsub.DEFAULT_RATES, jsub.VIDEO_EXT)
    for module in (tsub, jsub):
        monkeypatch.setattr(module, "iter_video_frames", fake_video_frames)
        monkeypatch.setattr(module, "iter_jpg_tar_frames", fake_jpg_tar_frames)
        monkeypatch.setattr(module, "_resize", fake_resize)
    raw = tmp_path / "raw"
    raw.mkdir()
    for name in ("b_vid", "a_vid", "c_vid"):
        (raw / f"{name}{ext}").write_bytes(b"")
    (raw / "notes.txt").write_bytes(b"")
    results = {}
    for label, module in (("port", tsub), ("jax", jsub)):
        out = tmp_path / label
        argv = ["--dataset", dataset, "--dataset-path", str(raw), "--output-path", str(out),
                "--subsampling-rate", rate, "--samples-per-shard", "4"]
        module.main(argv)
        want_rate = int(rate) if int(rate) > 0 else jsub.DEFAULT_RATES[dataset]
        (sub,) = os.listdir(out)
        assert sub == f"{dataset}_1in{want_rate}_images"
        results[label] = _shards(out / sub)
        # a rerun keeps every shard (resume check) and writes the same ones
        before = {fn: os.path.getmtime(out / sub / fn) for fn in os.listdir(out / sub)}
        module.main(argv)
        assert {fn: os.path.getmtime(out / sub / fn) for fn in os.listdir(out / sub)} == before
    port, jax_ = results["port"], results["jax"]
    assert list(port) == list(jax_) and len(port) > 1
    for fn in jax_:
        assert [m for m, _ in port[fn]] == [m for m, _ in jax_[fn]], fn
        for (m, got), (_, want) in zip(port[fn], jax_[fn]):
            np.testing.assert_array_equal(got, want, err_msg=m)
            assert got.shape == (224, 224, 3)


def test_cv2_decoders_match_jax(tmp_path):
    """Where OpenCV is installed, the port's decoders and resize on real
    codec output equal the JAX script's."""
    cv2 = pytest.importorskip("cv2")
    video = str(tmp_path / "v.mp4")
    writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"mp4v"), 10, (32, 32))
    assert writer.isOpened()
    for i in range(40):
        writer.write(np.full((32, 32, 3), (i * 6, 128, 255 - i * 6), np.uint8))
    writer.release()
    jpgs = str(tmp_path / "e.tar")
    with tarfile.open(jpgs, "w") as tar:
        for i in range(9):
            ok, buf = cv2.imencode(".jpg", np.full((24, 24, 3), i * 25, np.uint8))
            info = tarfile.TarInfo(f"frame_{i:010d}.jpg")
            info.size = len(buf)
            tar.addfile(info, io.BytesIO(buf.tobytes()))
    for fn, path, rate in (("iter_video_frames", video, 16), ("iter_jpg_tar_frames", jpgs, 4)):
        got, want = list(getattr(tsub, fn)(path, rate)), list(getattr(jsub, fn)(path, rate))
        assert [i for i, _ in got] == [i for i, _ in want] and len(got) == 3, fn
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(tsub._resize(g), jsub._resize(w))
            assert tsub._resize(g).shape == (224, 224, 3)


def test_subsampling_imports_cv2_only_in_its_decoders():
    src = inspect.getsource(tsub)
    assert not re.search(r"^import cv2|^from cv2", src, re.M)
    users = {name for name, fn in inspect.getmembers(tsub, inspect.isfunction)
             if "import cv2" in inspect.getsource(fn)}
    assert users == {"_resize", "iter_video_frames", "iter_jpg_tar_frames"}


# ---------------------------------------------------------------------------
# the shell scripts
# ---------------------------------------------------------------------------

SHELL_SCRIPTS = ("iv_feature_extraction.sh", "sanity_check_train_rvfm.sh")


def _commands(text):
    """A shell script's lines but its comments."""
    return [line for line in text.splitlines() if not line.lstrip().startswith("#") or line.startswith("#!")]


@pytest.mark.parametrize("script", SHELL_SCRIPTS)
def test_shell_script_syntax_and_modules(script):
    path = SCRIPTS / script
    subprocess.run(["bash", "-n", str(path)], check=True, timeout=30)
    text = path.read_text()
    assert "theia_tpu." not in text and "TPU host" not in text
    # the JAX script's commands with the port's module paths; its comments speak of the card
    jax_text = (Path(jsub.__file__).resolve().parent / script).read_text().replace("theia_tpu.", "theia_tpu_torch.")
    assert _commands(text) == _commands(jax_text)
    for module in re.findall(r"python -m (\S+)", text):
        assert module.startswith("theia_tpu_torch.scripts.")
        assert (SCRIPTS.parent.parent / (module.replace(".", "/") + ".py")).exists(), module


class Parsed(Exception):
    """Raised by the patched parse_args: the flags were accepted."""


def _command_flags(text, module):
    """The flags of each `python -m module` command in a shell script."""
    commands = re.findall(rf"python -m {re.escape(module)} ((?:[^\n]*\\\n)*[^\n]*)", text)
    assert commands, module
    return [re.findall(r"(--[\w-]+)", cmd) for cmd in commands]


@pytest.mark.parametrize("module", ["feature_extraction", "calc_feature_mean"])
def test_extraction_script_flags_are_accepted(monkeypatch, module):
    import importlib

    text = (SCRIPTS / "iv_feature_extraction.sh").read_text()
    mod = importlib.import_module(f"theia_tpu_torch.scripts.{module}")
    original = argparse.ArgumentParser.parse_args

    def parse_and_stop(self, args=None, namespace=None):
        raise Parsed(original(self, args, namespace))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_and_stop)
    for flags in _command_flags(text, f"theia_tpu_torch.scripts.{module}"):
        with pytest.raises(Parsed) as parsed:
            mod.main([arg for flag in flags for arg in (flag, "X")])
        assert all(getattr(parsed.value.args[0], f[2:].replace("-", "_")) == "X" for f in flags)


def test_sanity_script_overrides_and_data_are_accepted(tmp_path):
    text = (SCRIPTS / "sanity_check_train_rvfm.sh").read_text()
    (cmd,) = re.findall(r"python -m theia_tpu_torch.scripts.train_rvfm \\\n((?:[^\n]*\\\n)*[^\n]*)", text)
    overrides = [ov.replace('"', "").replace("$DATASET_ROOT", str(tmp_path)) for ov in re.findall(r"(\S+=\S+)", cmd)]
    assert len(overrides) == 8
    base = load_config("train_rvfm_imagenet")
    cfg = load_config("train_rvfm_imagenet", overrides=overrides)
    for ov in overrides:
        key, _, value = ov.partition("=")
        node, want = cfg, base
        for part in key.split("."):
            assert part in want, key  # the key exists: an override sets, it does not add
            node, want = node[part], want[part]
        assert str(node) == value, key
    # the heredoc's data: the default config's teachers (cdiv), at their real sizes
    (call,) = re.findall(r"generate_synthetic_dataset\((.*?)\)\n", text, re.S)
    kwargs = eval(f"dict({call.replace('sys.argv[1],', '')})")  # the script's literal arguments
    inspect.signature(generate_synthetic_dataset).bind(str(tmp_path), **kwargs)
    assert list(kwargs["feature_models"]) == list(cfg.training.target_models.target_model_names)
