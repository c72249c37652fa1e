"""One rank of tests/test_torch_tp.py and tests/test_torch_tp_audit.py: a
process of a gloo group on the CPU, started with torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

    python tests/torch_tp_worker.py SPEC.json

SPEC names the cases to run, the model axis, the 2-layer deit-small
Theia's state dict and the global batch. Each rank writes what it saw to
``<out>/rank<r>.pt``: whole tensors are gathered over its model group
first, so every rank's record is in the one-process layout. Imports no JAX.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from theia_tpu_torch.models import vit as tvit  # noqa: E402

SMALL = "facebook/deit-small-patch16-224"
tvit.BACKBONE_CONFIGS[SMALL] = dataclasses.replace(tvit.BACKBONE_CONFIGS[SMALL], num_layers=2)

from theia_tpu_torch.config import load_config  # noqa: E402
from theia_tpu_torch.models import losses as tlosses  # noqa: E402
from theia_tpu_torch.models.rvfm import Theia  # noqa: E402
from theia_tpu_torch.ops import ln_pallas  # noqa: E402
from theia_tpu_torch.parallel import audit  # noqa: E402
from theia_tpu_torch.parallel import distributed as pdist  # noqa: E402
from theia_tpu_torch.parallel import tp  # noqa: E402
from theia_tpu_torch.parallel.mesh import make_grid  # noqa: E402
from theia_tpu_torch.train import loop as tloop  # noqa: E402
from theia_tpu_torch.train import optim as toptim  # noqa: E402
from theia_tpu_torch.train import step as tstep  # noqa: E402
from theia_tpu_torch.train.state import TrainState  # noqa: E402


def _sizes(spec: dict, key: str = "targets") -> dict:
    return {t: tuple(s) for t, s in spec[key].items()}


def _rows(spec: dict, grid, key: str = "batch", names: str = "names"):
    """This data index's rows of the global batch: uint8 images and [B, HW, C] / [B, C] targets."""
    batch = np.load(spec[key])
    n = batch["images"].shape[0] // grid.n_data
    rows = slice(grid.data_index * n, (grid.data_index + 1) * n)
    return torch.from_numpy(batch["images"][rows]), {t: torch.from_numpy(batch[k][rows])
                                                     for k, t in spec[names].items()}


def _model(spec: dict, sizes: dict, state_dict: str, grid, **kw):
    model = Theia(backbone=SMALL, translator="lconv", target_feature_sizes=sizes, **kw)
    model.load_state_dict(torch.load(state_dict, weights_only=True), strict=True)
    layout = tp.shard_module(model, grid)
    return model, layout


def _steps(spec: dict, grid, out: dict, name: str, steps: int, **kw) -> None:
    """``steps`` train steps of the cut model on this data index's rows: the
    losses, step 1's collectives, and the whole parameters and moments after."""
    model, layout = _model(spec, _sizes(spec), spec["state_dict"], grid, **kw)
    tx = toptim.make_optimizer(toptim.constant_with_warmup(spec["lr"], 10), weight_decay=0.01,
                               moment_dtype=torch.bfloat16 if kw.get("fast_math") else None)
    step = tstep.make_train_step(model, tx, grad_clip=True, grad_clip_norm=spec["clip"])
    state = TrainState.create(dict(model.named_parameters()), tx)
    images, targets = _rows(spec, grid)
    losses, norms = [], []
    with audit.audit() as records:
        state, metrics = step(state, images, targets)
    losses.append(float(metrics["loss"]))
    norms.append(float(metrics["grad_norm"]))
    for _ in range(steps - 1):
        state, metrics = step(state, images, targets)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    opt = state.opt_state
    out[name] = dict(
        losses=losses, grad_norms=norms, records=list(records),
        params=tp.gather_state(state.params, layout), mu=tp.gather_state(opt.mu, layout),
        nu=tp.gather_state(opt.nu, layout), count={n: int(c) for n, c in opt.count.items()},
        local_shapes={n: tuple(p.shape) for n, p in state.params.items()},
        split=sorted(n for n in state.params if layout.is_split(n)),
        split_outputs=dict(layout.split_outputs))


def case_dp_audit(spec: dict, out: dict) -> None:
    """One data-parallel step (no model axis) under the audit."""
    grid = make_grid(1)
    model, _ = _model(spec, _sizes(spec), spec["state_dict"], grid)
    tx = toptim.make_optimizer(1e-4, weight_decay=0.01)
    step = tstep.make_train_step(model, tx)
    state = TrainState.create(dict(model.named_parameters()), tx)
    images, targets = _rows(spec, grid)
    with audit.audit() as records:
        step(state, images, targets)
    out["dp_audit"] = dict(records=list(records), n_params=sum(p.numel() for p in state.params.values()))


def case_tp_steps(spec: dict, out: dict) -> None:
    grid = make_grid(spec["n_model"])
    out["grid"] = (grid.n_data, grid.n_model, grid.data_index, grid.model_index)
    _steps(spec, grid, out, "tp", spec["steps"])


def case_tp_recipe(spec: dict, out: dict) -> None:
    """One step at the recipe: bf16 compute, fast_math, fused preprocessing."""
    grid = make_grid(spec["n_model"])
    _steps(spec, grid, out, "tp_recipe", 1, dtype=torch.bfloat16, fast_math=True, fuse_preprocessing=True)


def case_audit64(spec: dict, out: dict) -> None:
    """One exact-mode step of a model with a 64x64 head under the audit."""
    grid = make_grid(spec["n_model"])
    model, layout = _model(spec, _sizes(spec, "targets64"), spec["state_dict64"], grid)
    tx = toptim.make_optimizer(1e-4, weight_decay=0.01)
    step = tstep.make_train_step(model, tx)
    state = TrainState.create(dict(model.named_parameters()), tx)
    images, targets = _rows(spec, grid, "batch64", "names64")
    with audit.audit() as records:
        step(state, images, targets)
    out["audit64"] = dict(records=list(records))


def case_ln(spec: dict, out: dict) -> None:
    """A LayerNormSpatial on a channel-split map, its forward and backward,
    through LNSpatialFunction (the plain K3 -> all-reduce -> plain K4 on the
    CPU) and through autograd of the plain forward; gathered whole."""
    grid = make_grid(spec["n_model"])
    arrays = np.load(spec["ln"])
    c = arrays["x"].shape[1] // grid.n_model
    part = lambda a, d: torch.from_numpy(a).narrow(d, grid.model_index * c, c).contiguous()  # noqa: E731
    res = {}
    for impl in ("pallas", "vpu"):
        x = part(arrays["x"], 1).contiguous(memory_format=torch.channels_last).requires_grad_(True)
        w, b = part(arrays["w"], 0).requires_grad_(True), part(arrays["b"], 0).requires_grad_(True)
        if impl == "pallas":
            y = ln_pallas.LNSpatialFunction.apply(x, w, b, 1e-5, grid)
        else:
            y = ln_pallas.ln_spatial_plain(x, w, b, 1e-5, grid)
        y.backward(part(arrays["g"], 1))
        res[impl] = {k: torch.cat(pdist.all_gather(v.detach().contiguous(), grid.model_group), dim=d)
                     for k, v, d in (("y", y, 1), ("dx", x.grad, 1), ("dw", w.grad, 0), ("db", b.grad, 0))}
    out["ln"] = res


def case_loss(spec: dict, out: dict) -> None:
    """The loss on features split over the model group, fused (D >= 1024) and
    not, with its gradient, gathered whole."""
    grid = make_grid(spec["n_model"])
    arrays = np.load(spec["loss"])
    res = {}
    for key in ("wide", "narrow"):
        whole_p, whole_t = (torch.from_numpy(arrays[f"{key}_{k}"]) for k in ("pred", "target"))
        d = whole_p.shape[-1] // grid.n_model
        pred = whole_p.narrow(-1, grid.model_index * d, d).contiguous().requires_grad_(True)
        target = whole_t.narrow(-1, grid.model_index * d, d).contiguous()
        losses = tlosses.get_loss({"t": pred}, {"t": target}, split={"t": grid})
        main = tlosses.main_loss_from_terms(losses, "cos_l1")
        main.backward()
        res[key] = dict(terms=[float(losses[k]) for k in ("mse_loss", "l1_loss", "cos_loss")],
                        grad=torch.cat(pdist.all_gather(pred.grad, grid.model_group), dim=-1))
    out["loss"] = res


def case_loop(spec: dict, out: dict) -> None:
    """``train_from_config`` at ``model_axis``: one epoch, then resumed for a second."""
    seen = []
    make_train = tloop.make_train_step

    def train_step_spy(*a, **k):
        fn = make_train(*a, **k)

        def run(state, images, targets, masks=None):
            seen.append(images.clone())
            return fn(state, images, targets, masks)

        return run

    tloop.make_train_step = train_step_spy
    try:
        summaries = []
        for epochs in (1, 2):
            cfg = load_config("train_rvfm_imagenet", overrides=spec["overrides"] + [f"training.epochs={epochs}"])
            summaries.append(tloop.train_from_config(cfg, device="cpu"))
    finally:
        tloop.make_train_step = make_train
    out["loop"] = dict(steps=[s["step"] for s in summaries], train=seen,
                       losses=[s["train"]["avg_train_cos_loss"] for s in summaries],
                       ckpt_dir=summaries[-1]["ckpt_dir"])


CASES = {"dp_audit": case_dp_audit, "tp_steps": case_tp_steps, "tp_recipe": case_tp_recipe,
         "audit64": case_audit64, "ln": case_ln, "loss": case_loss, "loop": case_loop}


def main() -> None:
    torch.set_num_threads(1)
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank, world, device = pdist.init_distributed("cpu")
    assert (world, device.type, dist.get_backend()) == (spec["world"], "cpu", "gloo")
    out: dict = {"rank": rank}
    for case in spec["cases"]:
        CASES[case](spec, out)
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
