"""One rank of tests/test_torch_distributed.py: a process of a 2-rank gloo
group on the CPU, started with torchrun's environment (RANK, WORLD_SIZE,
LOCAL_RANK, MASTER_ADDR, MASTER_PORT).

    python tests/torch_dp_worker.py SPEC.json

SPEC names the 2-layer deit-tiny Theia's state dict and the global batch
(the step cases), and the shards and output directory (the loop case). The
rank writes what it saw to ``<out>/rank<r>.pt``. Imports no JAX.
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

TINY = "facebook/deit-tiny-patch16-224"
tvit.BACKBONE_CONFIGS[TINY] = dataclasses.replace(tvit.BACKBONE_CONFIGS[TINY], num_layers=2)

from theia_tpu_torch.config import load_config  # noqa: E402
from theia_tpu_torch.models.rvfm import Theia  # noqa: E402
from theia_tpu_torch.parallel import distributed as pdist  # noqa: E402
from theia_tpu_torch.train import loop as tloop  # noqa: E402
from theia_tpu_torch.train import optim as toptim  # noqa: E402
from theia_tpu_torch.train import step as tstep  # noqa: E402
from theia_tpu_torch.train.state import TrainState  # noqa: E402


def _clone(tree: dict) -> dict:
    return {n: t.detach().clone() for n, t in tree.items()}


def step_cases(spec: dict, rank: int, out: dict) -> None:
    """3 train steps on this rank's rows of the global batch, for each wire
    dtype: the losses, every all_reduce (elements, dtype), step 1's local
    and all-reduced gradients, and the parameters and moments after."""
    targets_sizes = {t: tuple(s) for t, s in spec["targets"].items()}
    sd = torch.load(spec["state_dict"], weights_only=True)
    batch = np.load(spec["batch"])
    b = spec["rows_per_rank"]
    rows = slice(rank * b, (rank + 1) * b)
    images = torch.from_numpy(batch["images"][rows])
    targets = {t: torch.from_numpy(batch[f"target{i}"][rows]) for i, t in enumerate(targets_sizes)}

    calls, grads_seen = [], []
    all_reduce, reduce_grads = dist.all_reduce, tstep.all_reduce_grads

    def counting(t, *a, **k):
        calls.append((t.numel(), str(t.dtype)))
        return all_reduce(t, *a, **k)

    def spy(grads, world, wire):
        reduced = reduce_grads(grads, world, wire)
        grads_seen.append((_clone(grads), _clone(reduced)))
        return reduced

    dist.all_reduce, tstep.all_reduce_grads = counting, spy
    try:
        for wire in ("bfloat16", "float32"):
            model = Theia(backbone=TINY, translator="lconv", target_feature_sizes=targets_sizes)
            model.load_state_dict(sd, strict=True)
            tx = toptim.make_optimizer(spec["lr"], weight_decay=0.01)
            step = tstep.make_train_step(model, tx, grad_allreduce_dtype=getattr(torch, wire))
            state = TrainState.create(dict(model.named_parameters()), tx)
            calls.clear()
            grads_seen.clear()
            losses = []
            for _ in range(spec["steps"]):
                state, metrics = step(state, images, targets)
                losses.append(float(metrics["loss"]))
            out[wire] = dict(losses=losses, calls=list(calls), local=grads_seen[0][0], reduced=grads_seen[0][1],
                             params=_clone(state.params), mu=_clone(state.opt_state.mu),
                             nu=_clone(state.opt_state.nu), count={n: int(c) for n, c in state.opt_state.count.items()},
                             step=int(state.step))
    finally:
        dist.all_reduce, tstep.all_reduce_grads = all_reduce, reduce_grads


def loop_case(spec: dict, out: dict) -> None:
    """``train_from_config`` for one epoch, then resumed for a second: the
    images of every train and eval step, the optimizer's learning rates,
    the model's final parameters."""
    seen = {"train": [], "eval": []}
    models = []
    make_train, make_eval, build = tloop.make_train_step, tloop.make_eval_step, tloop.build_model

    def train_step_spy(*a, **k):
        fn = make_train(*a, **k)

        def run(state, images, targets, masks=None):
            seen["train"].append(images.clone())
            return fn(state, images, targets, masks)

        return run

    def eval_step_spy(*a, **k):
        fn = make_eval(*a, **k)

        def run(images, targets):
            seen["eval"].append(images.clone())
            return fn(images, targets)

        return run

    def build_spy(*a, **k):
        models.append(build(*a, **k))
        return models[-1]

    tloop.make_train_step, tloop.make_eval_step, tloop.build_model = train_step_spy, eval_step_spy, build_spy
    try:
        summaries = []
        for epochs in (1, 2):
            cfg = load_config("train_rvfm_imagenet", overrides=spec["overrides"] + [f"training.epochs={epochs}"])
            summaries.append(tloop.train_from_config(cfg, device="cpu"))
    finally:
        tloop.make_train_step, tloop.make_eval_step, tloop.build_model = make_train, make_eval, build
    out["loop"] = dict(train=seen["train"], eval=seen["eval"], steps=[s["step"] for s in summaries],
                       timing=["timing" in s for s in summaries], params=_clone(dict(models[-1].named_parameters())),
                       evals=[s["eval"] for s in summaries])


def main() -> None:
    torch.set_num_threads(1)
    spec = json.loads(Path(sys.argv[1]).read_text())
    rank, world, device = pdist.init_distributed("cpu")
    assert (world, device.type, dist.get_backend()) == (2, "cpu", "gloo")
    out: dict = {"rank": rank}
    step_cases(spec, rank, out)
    loop_case(spec, out)
    torch.save(out, Path(spec["out"]) / f"rank{rank}.pt")
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
