"""Two tensor-parallel ranks of the train step on one card, over gloo.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=P \\
        python -m theia_tpu_torch.tools.tp_step --out DIR [--rows 16] [--steps 3] \\
        [--translators lconv,conv,mlp,transformer]

Run twice, r = 0 and 1, with torchrun's environment: both processes take
``cuda:0`` (NCCL refuses two ranks on one device; gloo takes CUDA tensors,
staging them through the host). The ranks form one model group
(``training.model_axis=2``, one data index). For each of ``translators`` in
turn, in the one pair of processes, Theia-Base cddsv with that translator
at its config's widths (``configs/model/translator/<t>.yaml``) is built
from one seed on each rank, cut by ``parallel.tp.shard_module``, and both
ranks take the same seeded global batch of ``rows``:

  - at the production recipe (bf16 compute, ``fast_math``, fused
    preprocessing, bf16 Adam moments), ``steps`` train steps, the first
    under the collective audit: the losses, each step's time and the time
    of its all-reduces (CUDA events; gloo's host staging included), the
    kernels' launches, the peak memory of the rank, the split layers the
    model-group collectives follow from; then whether the replicated
    parameters are bit-equal on the two ranks, and the whole parameters,
    gathered (rank 0 saves them for the caller, which runs the same steps
    in one process: a rank's own steps would all-reduce over the group);
    one more step in which the replicated gradients are compared across the
    ranks before the bucket that averages them (how far the card's
    rounding sets them apart);
  - for those of ``EXACT_TRANSLATORS`` (float32 compute; the ones whose
    heads run K3/K4), one step: the launches, the gathered
    all-reduced gradient's relative L2 from one process's gradient on the
    same batch (plain autograd on rank 0), and the replicated gradients'
    spread.

Each rank writes ``DIR/rank<r>.json`` (a record a translator); rank 0 also
``DIR/params_<translator>.pt``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import torch
import torch.distributed as dist

from theia_tpu_torch.tools.two_rank_step import (
    EXACT, LR, MODEL, RECIPE, SEED, _same_on_both_ranks, global_batch, launch_counts, translator_kwargs,
)

# the translators that also take an exact-mode step: the ones with conv ladders
EXACT_TRANSLATORS = ("lconv", "conv")


def build_cut_model(flags: dict, device: torch.device, grid, translator: str = "lconv"):
    """Theia-Base cddsv with ``translator`` from the seed, float32 params in
    train mode, made the same on every rank, cut over ``grid``; its masked
    AdamW and TrainState."""
    from theia_tpu_torch.models.hub import build_theia
    from theia_tpu_torch.parallel.distributed import broadcast_module
    from theia_tpu_torch.parallel.tp import shard_module
    from theia_tpu_torch.train.optim import make_optimizer
    from theia_tpu_torch.train.state import TrainState

    model = build_theia(MODEL, device=device, generator=torch.Generator().manual_seed(SEED), translator=translator,
                        translator_kwargs=translator_kwargs(translator), **flags).train()
    broadcast_module(model)
    layout = shard_module(model, grid)
    tx = make_optimizer(LR, weight_decay=0.01, moment_dtype=torch.bfloat16 if flags.get("fast_math") else None)
    return model, tx, TrainState.create(dict(model.named_parameters()), tx), layout


def split_layers(model: torch.nn.Module) -> dict:
    """The translator's split layers by role, and its predictions whose
    features stay split: what its model-group collectives follow from."""
    from theia_tpu_torch.models.layers import LayerNormSpatial

    counts = {"col": 0, "row": 0, "ln_shard": 0}
    for m in model.translator.modules():
        role = getattr(m, "tp_role", None)
        if role in ("col", "row"):
            counts[role] += 1
        elif isinstance(m, LayerNormSpatial) and m.tp is not None:
            counts["ln_shard"] += 1
    counts["split_outputs"] = sum(model.tp_layout.split_outputs.values())
    counts["blocks"] = len(model.backbone.model.encoder["layer"])
    return counts


def _flat(tree: dict) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1).float() for t in tree.values()])


def _spread(tensors: list[torch.Tensor]) -> dict:
    """How rank 1's tensors differ from rank 0's: elements that differ and
    the largest difference (rank 0's broadcast, compared on every rank)."""
    from theia_tpu_torch.parallel.distributed import broadcast

    mine = _flat(dict(enumerate(tensors)))
    theirs = broadcast(mine.clone(), 0)
    diff = (mine - theirs).abs()
    return {"elements": mine.numel(), "differ": int((diff > 0).sum()), "max_abs": float(diff.max())}


class _SpreadSpy:
    """While on, ``train.step.all_reduce_grads`` notes the spread of the
    replicated bucket's gradients (the one over the world) before reducing."""

    def __init__(self):
        from theia_tpu_torch.train import step as tstep

        self.tstep, self.reduce, self.seen = tstep, tstep.all_reduce_grads, []

    def __call__(self, grads, world, wire=None, group=None):
        if group is None:
            self.seen.append(_spread(list(grads.values())))
        return self.reduce(grads, world, wire, group)

    def __enter__(self):
        self.seen.clear()
        self.tstep.all_reduce_grads = self
        return self

    def __exit__(self, *exc):
        self.tstep.all_reduce_grads = self.reduce


def recipe_steps(translator: str, steps: int, images, targets, device, grid, out: Path) -> dict:
    """``steps`` timed recipe steps of the cut model (the first under the
    audit), then one whose replicated gradients are compared across the ranks."""
    from theia_tpu_torch.parallel.audit import audit, summarize
    from theia_tpu_torch.parallel.tp import gather_state
    from theia_tpu_torch.train import step as tstep

    spans: list[tuple[torch.cuda.Event, torch.cuda.Event, int]] = []
    all_reduce = dist.all_reduce

    def timed(t, *a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        res = all_reduce(t, *a, **k)
        end.record()
        spans.append((start, end, t.numel() * t.element_size()))
        return res

    model, tx, state, layout = build_cut_model(RECIPE, device, grid, translator)
    step = tstep.make_train_step(model, tx)
    before = launch_counts()
    torch.cuda.reset_peak_memory_stats(device)
    losses, step_ms, allreduce_ms, allreduce_bytes, records = [], [], [], [], []
    dist.all_reduce = timed
    try:
        for i in range(steps):
            spans.clear()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            with audit() if i == 0 else contextlib.nullcontext(records) as records:  # the first step's collectives
                start.record()
                state, metrics = step(state, images, targets)
                end.record()
            losses.append(metrics["loss"])
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            allreduce_ms.append([s.elapsed_time(e) for s, e, _ in spans])
            allreduce_bytes.append([n for _, _, n in spans])
    finally:
        dist.all_reduce = all_reduce
    after = launch_counts()
    rec = dict(
        losses=[float(x) for x in losses], step_ms=step_ms, allreduce_ms=allreduce_ms,
        allreduce_bytes=allreduce_bytes, peak_bytes=torch.cuda.max_memory_allocated(device),
        launches={k: after[k] - before[k] for k in after}, audit=summarize(records), split_layers=split_layers(model),
        n_split=sum(layout.is_split(n) for n in state.params), n_params=len(state.params),
        replicated_equal=_same_on_both_ranks([p for n, p in state.params.items() if not layout.is_split(n)]),
        local_elements=sum(p.numel() for p in state.params.values()))
    # the whole parameters after the timed steps, for the caller's one-process run
    whole_params = {n: t.cpu() for n, t in gather_state(state.params, layout).items()}
    if dist.get_rank() == 0:
        out.mkdir(parents=True, exist_ok=True)
        torch.save(whole_params, out / f"params_{translator}.pt")
    del whole_params
    with _SpreadSpy() as spy:
        step(state, images, targets)
    rec["replicated_grad_spread"] = spy.seen[0]
    del model, tx, state, step
    torch.cuda.empty_cache()
    return rec


def exact_step(translator: str, images, targets, device, grid) -> dict:
    """One float32 step: the gathered gradient against one process's (rank 0)."""
    from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
    from theia_tpu_torch.parallel.tp import gather_state
    from theia_tpu_torch.tools.two_rank_step import build_model
    from theia_tpu_torch.train import step as tstep

    rank = dist.get_rank()
    whole = None
    if rank == 0:
        model, _, _ = build_model(EXACT, device, translator)
        params = list(model.parameters())
        loss = main_loss_from_terms(get_loss(model(images), tstep.prepare_targets(targets)), "cos_l1")
        found = torch.autograd.grad(loss, params, allow_unused=True)
        whole = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(params, found)])
        del model, params, loss, found
    model, tx, state, layout = build_cut_model(EXACT, device, grid, translator)
    seen: dict = {}

    class Keep:  # the optimizer, keeping the gradients it takes
        def update(self, grads, *a, **k):
            seen.update(grads)
            return tx.update(grads, *a, **k)

    before = launch_counts()
    step = tstep.make_train_step(model, Keep())
    with _SpreadSpy() as spy:
        state, metrics = step(state, images, targets)
    after = launch_counts()
    got = _flat(gather_state({n: seen[n] for n in state.params}, layout))
    rec = dict(loss=float(metrics["loss"]), replicated_grad_spread=spy.seen[0],
               launches={k: after[k] - before[k] for k in after})
    if rank == 0:
        rec["grad_rel_l2_whole"] = float((got.double() - whole.double()).norm() / whole.double().norm())
    del model, tx, state, step, got, whole
    torch.cuda.empty_cache()
    return rec


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--rows", type=int, default=16)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--translators", default="lconv", help="comma-separated, run in this order")
    args = parser.parse_args(argv)

    from theia_tpu_torch.parallel.distributed import init_distributed
    from theia_tpu_torch.parallel.mesh import make_grid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_distributed("cuda", backend="gloo")
    assert world == 2, f"two ranks, got {world}"
    grid = make_grid(2)
    images, targets = global_batch(args.rows, device)
    record: dict = {"rank": rank, "device": str(device), "rows": args.rows, "backend": dist.get_backend(),
                    "translators": {}}
    for t in filter(None, args.translators.split(",")):
        rec = {"recipe": recipe_steps(t, args.steps, images, targets, device, grid, args.out)}
        if t in EXACT_TRANSLATORS:
            rec["exact"] = exact_step(t, images, targets, device, grid)
        record["translators"][t] = rec
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"rank{rank}.json").write_text(json.dumps(record))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
