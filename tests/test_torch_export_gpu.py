"""The port's deployment artifact on the card (theia_tpu_torch/export.py):
the exported graph reaches K1 through its operator ``theia::mha_attention``
and launches the kernel when it runs. Needs a CUDA device; imports no JAX,
so it runs on the card's machine, without the JAX-importing conftest:
``python -m pytest --noconftest tests/test_torch_export_gpu.py``. Tolerance: float32 atol 1e-5 against the
eager model (the same kernels and float32 ops)."""

import dataclasses

import numpy as np
import pytest
import torch

from theia_tpu_torch import export as texport
from theia_tpu_torch.models import vit
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.ops import attention

NAME = "facebook/deit-tiny-patch16-224"
TARGETS = {"facebook/dinov2-large": (1024, 16, 16)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_exported_forward_feature_launches_k1(cuda, monkeypatch):
    monkeypatch.setitem(vit.BACKBONE_CONFIGS, NAME, dataclasses.replace(vit.BACKBONE_CONFIGS[NAME], num_layers=2))
    model = Theia(backbone=NAME, translator="lconv", target_feature_sizes=TARGETS)
    model.reset_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda).eval()
    pred = texport.ExportedPredictor(texport.export_model(model))
    assert pred.meta["platforms"] == ["cuda"]
    assert "theia.mha_attention.default" in {str(n.target) for n in pred.program.graph.nodes}
    for n in (1, 3):
        imgs = np.random.RandomState(n).randint(0, 256, (n, 224, 224, 3), np.uint8)
        before = attention.MHA_FWD_LAUNCHES
        got = pred(imgs)
        assert attention.MHA_FWD_LAUNCHES - before == 2
        with torch.inference_mode():
            want = model.forward_feature(torch.from_numpy(imgs).to(cuda)).cpu().numpy()
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
