"""The port's public names against the JAX package's: each subpackage's
``__all__`` through an explicit table of renamed and left-out names, the
version, and the data shims (``get_frame_iterator``, the OXE loader
functions, ``totensor``, ``denormalize_feature``) on seeded inputs."""

import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import theia_tpu
import theia_tpu_torch
from theia_tpu.data import dataset as jds
from theia_tpu.data import oxe as joxe
from theia_tpu.data import stats as jstats
from theia_tpu_torch.data import dataset as tds
from theia_tpu_torch.data import oxe as toxe
from theia_tpu_torch.data import stats as tstats

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_data import _assert_same, _packed_oxe  # noqa: E402

SUBPACKAGES = ("data", "models", "train", "ops", "utils")
# JAX name -> the port's, where the port's returns tensors under another name
RENAMED = {
    "data": {"load_safetensors_np": "load_safetensors", "save_safetensors_np": "save_safetensors"},
}
# JAX names the port does not export, each with its reason
LEFT_OUT = {
    "ops": {
        "conv_transpose_2d": "ops/convt.py: the JAX package's TPU lowering of a transposed convolution, a toggle "
                             "the North star leaves out (the port calls F.conv_transpose2d)",
        "torch_conv_init": "ops/init.py: the JAX emulation of torch.nn.init",
        "torch_conv_transpose_init": "ops/init.py: the JAX emulation of torch.nn.init",
        "torch_linear_init": "ops/init.py: the JAX emulation of torch.nn.init",
        "torch_linear_bias_init": "ops/init.py: the JAX emulation of torch.nn.init",
        "trunc_normal_init": "ops/init.py: the JAX emulation of torch.nn.init",
    },
}


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_all_matches_the_jax_package(sub):
    jmod = importlib.import_module(f"theia_tpu.{sub}")
    tmod = importlib.import_module(f"theia_tpu_torch.{sub}")
    left_out = LEFT_OUT.get(sub, {})
    assert set(left_out) <= set(jmod.__all__)
    renamed = RENAMED.get(sub, {})
    want = [renamed.get(name, name) for name in jmod.__all__ if name not in left_out]
    assert tmod.__all__ == want
    for name in tmod.__all__:
        obj = getattr(tmod, name)
        assert getattr(obj, "__module__", f"theia_tpu_torch.{sub}").startswith("theia_tpu_torch."), name


def test_version():
    assert theia_tpu_torch.__version__ == theia_tpu.__version__ == "0.1.0"


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_denormalize_feature_matches_jax(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 4)).astype(dtype)
    mean = rng.standard_normal((5, 1, 1)).astype(np.float32)
    std = rng.uniform(0.5, 2.0, (5, 1, 1)).astype(np.float32)
    want = jstats.denormalize_feature(x, mean, std)
    got = tstats.denormalize_feature(torch.from_numpy(x), torch.from_numpy(mean), torch.from_numpy(std))
    assert got.numpy().dtype == want.dtype == dtype
    np.testing.assert_array_equal(got.numpy(), want)
    # the inverse of normalize_feature, up to rounding
    back = tstats.normalize_feature(got, torch.from_numpy(mean), torch.from_numpy(std))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5 if dtype == np.float32 else 1e-2)


def test_totensor_matches_jax():
    arr = np.random.default_rng(0).integers(0, 256, (4, 6, 3), dtype=np.uint8)
    got = toxe.totensor(arr)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), joxe.totensor(arr))


def test_oxe_loader_and_iterators_match_jax(tmp_path):
    _packed_oxe(str(tmp_path))
    kw = dict(dataset_root=str(tmp_path), dataset_mix=["berkeley_cable_routing"],
              feature_models=["facebook/dinov2-large"], split="train", dataset_ratio=1.0, seed=0)
    loader_kw = dict(batch_size=3, shuffle=True, shuffle_buffer_size=4, drop_last=False)
    want = list(joxe.get_oxe_frame_iterator(joxe.get_oxe_frame_dataloader(joxe.get_oxe_frame_dataset(**kw)[0],
                                                                           **loader_kw)))
    got = list(toxe.get_oxe_frame_iterator(toxe.get_oxe_frame_dataloader(toxe.get_oxe_frame_dataset(**kw)[0],
                                                                         **loader_kw)))
    generic = list(tds.get_frame_iterator(tds.get_frame_dataloader(toxe.get_oxe_frame_dataset(**kw)[0],
                                                                   **loader_kw)))
    jgeneric = list(jds.get_frame_iterator(jds.get_frame_dataloader(joxe.get_oxe_frame_dataset(**kw)[0],
                                                                    **loader_kw)))
    assert len(got) == len(want) == len(generic) == len(jgeneric) > 1
    for i, (jb, tb, gb, jg) in enumerate(zip(want, got, generic, jgeneric)):
        _assert_same(jb, tb, f"oxe batch {i}")
        _assert_same(jb, gb, f"generic batch {i}")
        _assert_same(jg, gb, f"jax generic batch {i}")
