"""The plain reference against the program at a tiny size, on seeded weights.

On the CPU: the port's ``forward_feature`` (plain preprocessing, exact
attention, float32) and one recipe train step computed in float32 agree
with the reference to float32 rounding; the recipe's own bf16 step agrees
to bf16 rounding; the reference's parameter layout is the port's
(``strict=True``). On the card (``gpu``): the same through the CUDA kernels.
"""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import check, inputs, port, spec
from perfbench.drivers.train import Driver as Train
from perfbench.reference import model as ref
from perfbench.reference import train as ref_train
from perfbench.tests import tiny


def _device(kind: str) -> torch.device:
    if kind == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(kind)


def _recipe(dtype: str) -> dict:
    traffic = copy.deepcopy(spec.load_json(spec.traffic_file("train_recipe")))
    if dtype == "float32":
        traffic["recipe"].update(compute_dtype="float32", moment_dtype="float32")
    return traffic


def _forward_feature_gap(device: torch.device) -> float:
    cfg = tiny.config()
    gen = inputs.generator(7, device)
    params = ref.make_params(cfg, gen)
    images = inputs.images(3, cfg, gen)
    model = port.build(cfg, params, dtype=torch.float32).eval()
    with torch.no_grad(), ref.precision_flags("float32"):
        got = model.forward_feature(images)
        want = ref.forward_feature(params, images, cfg)
    return check.rel_l2(got, want)


def _train_numbers(device: torch.device, dtype: str) -> dict[str, float]:
    drv = Train(tiny.config(), _recipe(dtype), {"batch": 4}, 11, device)
    with ref.precision_flags("float32"):
        drv.setup()
    drv.free()
    return check.train_numbers(drv.prog, drv.reference())[0]


def test_parameter_layout_is_the_ports():
    cfg = tiny.config()
    params = ref.make_params(cfg, inputs.generator(1, torch.device("cpu")))
    model = port.build(cfg, params, dtype=torch.float32)  # loads strict=True
    assert list(params) == [n for n, *_ in ref.param_spec(cfg)]
    assert set(params) == set(model.state_dict())


@pytest.mark.parametrize("kind", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_forward_feature_matches_reference(kind):
    assert _forward_feature_gap(_device(kind)) < 1e-5


@pytest.mark.parametrize("kind", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_float32_train_step_matches_reference(kind):
    numbers = _train_numbers(_device(kind), "float32")
    assert numbers["loss_gap"] < 1e-5
    assert numbers["grad_gap"] < 1e-3
    assert numbers["update_gap"] < 1e-3


@pytest.mark.parametrize("kind", ["cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_recipe_train_step_matches_reference_to_bf16(kind):
    numbers = _train_numbers(_device(kind), "bfloat16")
    assert numbers["loss_gap"] < 1e-3
    assert numbers["grad_gap"] < 5e-2
    assert numbers["update_gap"] < 5e-2


def test_fp8_control_reads_wider_than_the_program():
    """The control, the reference in fp8, sits further from the float32
    reference than the bf16 program does, in the loss and in the gradient."""
    drv = Train(tiny.config(), _recipe("bfloat16"), {"batch": 4}, 5, torch.device("cpu"))
    drv.setup()
    drv.free()
    exact = drv.reference()
    prog = check.train_numbers(drv.prog, exact)[0]
    control = check.train_numbers(drv.reference("fp8"), exact)[0]
    assert control["loss_gap"] > 2 * prog["loss_gap"]
    assert control["grad_gap"] > 2 * prog["grad_gap"]


def test_block_rows():
    """Blocks of 32 images for Theia-Base, 64 for Theia-Small."""
    assert ref.block_rows(spec.load_json(spec.PACKAGE / "configs" / "theia-base-cddsv.json")) == 32
    assert ref.block_rows(spec.load_json(spec.PACKAGE / "configs" / "theia-small-cddsv.json")) == 64


def test_reference_step_is_the_same_in_blocks():
    """The reference's trajectory over blocks of one image is the whole
    batch's, to float32 rounding."""
    drv = Train(tiny.config(), _recipe("bfloat16"), {"batch": 4}, 3, torch.device("cpu"))
    drv.setup()
    drv.free()
    batches = drv.ring[:2]
    whole, blocks = (ref_train.follow(drv.params0, batches, drv.stats, drv.cfg, drv.recipe, rows=rows)
                     for rows in (4, 1))
    numbers = check.train_numbers(blocks, whole)[0]
    assert numbers["loss_gap"] < 1e-6
    assert numbers["grad_diff"] < 1e-5
    assert numbers["update_gap"] < 1e-5
