"""Framework boundary of the PyTorch port: importing it loads no JAX, Flax,
Triton or ml_dtypes, and its copied tables equal the JAX package's."""

import dataclasses
import json
import subprocess
import sys

from pathlib import Path

import pytest

import theia_tpu_torch as tpackage
from theia_tpu.data import registries as jregistries
from theia_tpu.foundation import common as jcommon
from theia_tpu.foundation import depth_anything as jda
from theia_tpu.foundation import llava as jllava
from theia_tpu.foundation import sam as jsam
from theia_tpu.foundation import towers as jtowers
from theia_tpu.foundation import vit as jfvit
from theia_tpu.models import hub as jhub
from theia_tpu.models import vit as jvit
from theia_tpu_torch.data import registries as tregistries
from theia_tpu_torch.foundation import common as tcommon
from theia_tpu_torch.foundation import depth_anything as tda
from theia_tpu_torch.foundation import llava as tllava
from theia_tpu_torch.foundation import sam as tsam
from theia_tpu_torch.foundation import towers as ttowers
from theia_tpu_torch.foundation import vit as tfvit
from theia_tpu_torch.models import hub as thub
from theia_tpu_torch.models import vit as tvit

SLICE_MODULES = [
    "theia_tpu_torch",
    "theia_tpu_torch.config",
    "theia_tpu_torch.utils",
    "theia_tpu_torch.utils.seed",
    "theia_tpu_torch.utils.logging",
    "theia_tpu_torch.data",
    "theia_tpu_torch.data.registries",
    "theia_tpu_torch.data.stats",
    "theia_tpu_torch.data.webdataset",
    "theia_tpu_torch.data.dataset",
    "theia_tpu_torch.data.parallel_loader",
    "theia_tpu_torch.data.synthetic",
    "theia_tpu_torch.data.oxe",
    "theia_tpu_torch.train.checkpoint",
    "theia_tpu_torch.train.loop",
    "theia_tpu_torch.scripts",
    "theia_tpu_torch.scripts.train_rvfm",
    "theia_tpu_torch.foundation",
    "theia_tpu_torch.foundation.common",
    "theia_tpu_torch.foundation.towers",
    "theia_tpu_torch.foundation.clip",
    "theia_tpu_torch.foundation.dinov2",
    "theia_tpu_torch.foundation.llava",
    "theia_tpu_torch.foundation.vit",
    "theia_tpu_torch.foundation.sam",
    "theia_tpu_torch.foundation.depth_anything",
    "theia_tpu_torch.foundation.extraction",
    "theia_tpu_torch.foundation.sam_decoder",
    "theia_tpu_torch.decoding",
    "theia_tpu_torch.decoding.amg",
    "theia_tpu_torch.decoding.sam",
    "theia_tpu_torch.decoding.dinov2",
    "theia_tpu_torch.decoding.depth_anything",
    "theia_tpu_torch.decoding.decode",
    "theia_tpu_torch.scripts.decoding_example",
    "theia_tpu_torch.scripts.feature_extraction",
    "theia_tpu_torch.scripts.calc_feature_mean",
    "theia_tpu_torch.scripts.check_feature",
    "theia_tpu_torch.scripts.organize_imagenet_webdataset",
    "theia_tpu_torch.scripts.split_dataset",
    "theia_tpu_torch.ops.image",
    "theia_tpu_torch.ops.init",
    "theia_tpu_torch.ops.attention",
    "theia_tpu_torch.ops.ln_pallas",
    "theia_tpu_torch.ops.fused_loss",
    "theia_tpu_torch.kernels.build",
    "theia_tpu_torch.models.vit",
    "theia_tpu_torch.models.utils",
    "theia_tpu_torch.models.activations",
    "theia_tpu_torch.models.layers",
    "theia_tpu_torch.models.adapter_heads",
    "theia_tpu_torch.models.translators",
    "theia_tpu_torch.models.rvfm",
    "theia_tpu_torch.models.convert",
    "theia_tpu_torch.models.hub",
    "theia_tpu_torch.models.pretrained",
    "theia_tpu_torch.export",
    "theia_tpu_torch.models.losses",
    "theia_tpu_torch.serving",
    "theia_tpu_torch.train",
    "theia_tpu_torch.train.optim",
    "theia_tpu_torch.train.state",
    "theia_tpu_torch.train.step",
    "theia_tpu_torch.tools.check_div_rn",
    "theia_tpu_torch.tools.profile_train_step",
    "theia_tpu_torch.tools.sass_loops",
    "theia_tpu_torch.tools.time_ln_bwd",
    "theia_tpu_torch.tools.time_mha_bwd",
    "theia_tpu_torch.tools.time_serving",
    "theia_tpu_torch.tools.timing",
]


def test_port_imports_no_jax_flax_or_triton():
    code = (
        "import importlib, json, sys\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                  if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'triton', 'theia_tpu',\n"
        "                                         'ml_dtypes'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_every_port_module_is_checked():
    """SLICE_MODULES names every module of the package."""
    root = Path(tpackage.__file__).parent
    found = {".".join(("theia_tpu_torch", *p.relative_to(root).with_suffix("").parts)).removesuffix(".__init__")
             for p in root.rglob("*.py") if "_build" not in p.parts}
    assert found == set(SLICE_MODULES) | {"theia_tpu_torch.foundation", "theia_tpu_torch.kernels",
                                          "theia_tpu_torch.models", "theia_tpu_torch.ops",
                                          "theia_tpu_torch.tools"}


def test_copied_tables_equal_the_jax_package():
    assert tcommon.MODELS == jcommon.MODELS
    assert tcommon.MODEL_FEATURE_SIZES == jcommon.MODEL_FEATURE_SIZES
    assert thub.TEACHER_SETS == jhub.TEACHER_SETS
    assert tregistries.ALL_IMAGE_DATASETS == jregistries.ALL_IMAGE_DATASETS
    assert tregistries.ALL_VIDEO_DATASETS == jregistries.ALL_VIDEO_DATASETS
    assert (Path(tpackage.__file__).parent / "data" / "oxe_catalog.json").read_bytes() == (
        Path(jregistries.__file__).parent / "oxe_catalog.json").read_bytes()
    assert set(tvit.BACKBONE_CONFIGS) == set(jvit.BACKBONE_CONFIGS)
    for name, jcfg in jvit.BACKBONE_CONFIGS.items():
        tcfg = tvit.BACKBONE_CONFIGS[name]
        # every field but the attention default: the port's main path runs its kernel
        assert dataclasses.replace(tcfg, attention_impl=jcfg.attention_impl) == tvit.ViTBackboneConfig(
            **dataclasses.asdict(jcfg)
        ), name
        assert tcfg.attention_impl == "pallas"


def test_copied_teacher_constants_equal_the_jax_package():
    """The processors' means and stds, the towers' configs, SAM-H's,
    Depth-Anything-L's, ViT-H's and the DeiT teachers' equal the JAX
    package's (the ViT configs but for the attention default, as above)."""
    for name in ("CLIP_MEAN", "CLIP_STD", "IMAGENET_MEAN", "IMAGENET_STD"):
        assert getattr(ttowers, name) == getattr(jtowers, name), name
    for t, j in ((ttowers.CLIP_VIT_LARGE, jtowers.CLIP_VIT_LARGE), (ttowers.DINOV2_LARGE, jtowers.DINOV2_LARGE),
                 (tllava.LLAVA_VISION, jllava.LLAVA_VISION), (tsam.SAM_VIT_HUGE, jsam.SAM_VIT_HUGE),
                 (tda.DEPTH_ANYTHING_LARGE.backbone, jda.DEPTH_ANYTHING_LARGE.backbone)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j), t
    tda_fields = {k: v for k, v in dataclasses.asdict(tda.DEPTH_ANYTHING_LARGE).items() if k != "backbone"}
    assert tda_fields == {k: v for k, v in dataclasses.asdict(jda.DEPTH_ANYTHING_LARGE).items() if k != "backbone"}
    assert set(tfvit.DEIT_TEACHERS) == set(jfvit.DEIT_TEACHERS)
    for t, j in [(tfvit.VIT_HUGE, jfvit.VIT_HUGE)] + [(tfvit.DEIT_TEACHERS[n], jfvit.DEIT_TEACHERS[n])
                                                     for n in jfvit.DEIT_TEACHERS]:
        assert dataclasses.replace(t, attention_impl=j.attention_impl) == tvit.ViTBackboneConfig(**dataclasses.asdict(j))
        assert t.attention_impl == "pallas"
    assert (tcommon.get_max_model_spatial_size(True) == jcommon.get_max_model_spatial_size(True))


@pytest.mark.parametrize(
    "name", ["theaiinstitute/theia-base-patch16-224-cddsv", "theia-tiny-patch16-224", "theia-small-patch16-224-cdis"]
)
def test_parse_model_name_matches_jax(name):
    assert thub.parse_model_name(name) == jhub.parse_model_name(name)
