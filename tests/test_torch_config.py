"""The port's config system (theia_tpu_torch/config.py over its own YAML tree,
theia_tpu_torch/configs/) against the JAX package's theia_tpu/config.py:
the same composition, group swaps and dotted overrides, compared as plain
dicts (exact equality, value types included)."""

from pathlib import Path

import pytest
import yaml

from theia_tpu import config as jconfig
from theia_tpu_torch import config as tconfig

JTREE = Path(jconfig.DEFAULT_CONFIG_PATH)
TTREE = Path(tconfig.DEFAULT_CONFIG_PATH)
ROOTS = sorted(p.stem for p in JTREE.glob("*.yaml"))
TEACHER_SETS = sorted(p.stem for p in (JTREE / "training" / "target_models").glob("*.yaml"))
GROUP_SWAPS = [
    f"{group}={p.stem}"
    for group in ("dataset", "model/backbone", "model/translator", "logging")
    for p in sorted((JTREE / group).glob("*.yaml"))
]
OVERRIDES = [
    ["model/backbone=deit_reg", "model/translator=mlp", "training/target_models=cddsv", "training.batch_size=32",
     "training.grad_clip=true", "dataset.dataset_ratio=1.0"],
    ["model/backbone=deit_base", "training/target_models=cddsv", "dataset.dataset_root=/tmp/x",
     "dataset.dataset_ratio=1.0", "training.batch_size=16", "training.epochs=1", "logging.save_ckpt_interval=3",
     "logging.log_interval=2", "logging.model_path=/tmp/x/ckpt", "logging.log_path=/tmp/x/logs"],
    ["training.base_lr=2.0e-3", "training.optimizer.eps=1.0e-8", "training.moment_dtype=null",
     "dataset.feature_norm=true", "dataset.dataset_mix=[imagenet, ego4d]", "logging.notes='a b'",
     "training.optimizer.betas=[0.8, 0.99]", "new.nested.key=7", "training.compute_dtype=float32"],
    ["dataset=oxe_octo_mix", "dataset.dataset_mix=[berkeley_cable_routing]", "training.random_target_models=2",
     "training.distill_cls=true"],
]


def _both(name, overrides=()):
    return jconfig.load_config(name, list(overrides)).to_dict(), tconfig.load_config(name, list(overrides)).to_dict()


def test_tree_is_a_copy_file_for_file():
    jfiles = sorted(p.relative_to(JTREE) for p in JTREE.rglob("*.yaml"))
    assert jfiles == sorted(p.relative_to(TTREE) for p in TTREE.rglob("*.yaml"))
    for rel in jfiles:
        assert yaml.safe_load((TTREE / rel).read_text()) == yaml.safe_load((JTREE / rel).read_text()), rel


@pytest.mark.parametrize("root", ROOTS)
def test_root_config_composes_equal(root):
    want, got = _both(root)
    assert got == want
    assert tconfig.to_yaml(tconfig.DotDict.wrap(got)) == jconfig.to_yaml(jconfig.DotDict.wrap(want))


@pytest.mark.parametrize("teachers", TEACHER_SETS)
def test_teacher_set_composes_equal(teachers):
    want, got = _both("train_rvfm_imagenet", [f"training/target_models={teachers}"])
    assert got == want
    assert got["training"]["target_models"]["target_model_names"]


@pytest.mark.parametrize("swap", GROUP_SWAPS)
def test_group_swap_composes_equal(swap):
    want, got = _both("train_rvfm_imagenet", [swap])
    assert got == want


@pytest.mark.parametrize("overrides", OVERRIDES, ids=range(len(OVERRIDES)))
def test_overrides_compose_equal(overrides):
    want, got = _both("train_rvfm_imagenet", overrides)
    assert got == want


def test_dotdict_attribute_access():
    cfg = tconfig.load_config("train_rvfm_imagenet", ["training.batch_size=32"])
    assert cfg.training.batch_size == 32 and cfg.training.optimizer.betas == [0.9, 0.999]
    assert cfg.training.base_lr == 2e-3 and isinstance(cfg.training.base_lr, float)
    cfg.logging.run_identifier_prefix = "run"
    assert cfg["logging"]["run_identifier_prefix"] == "run"
    with pytest.raises(AttributeError):
        cfg.no_such_key
