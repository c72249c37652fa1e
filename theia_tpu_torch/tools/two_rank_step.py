"""Two data-parallel ranks of the train step on one card, over gloo.

    RANK=r WORLD_SIZE=2 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1 MASTER_PORT=P \\
        python -m theia_tpu_torch.tools.two_rank_step --out DIR [--rows 8] [--steps 3]

Run twice, r = 0 and 1, with torchrun's environment: both processes take
``cuda:0`` (NCCL refuses two ranks on one device; gloo takes CUDA tensors,
staging them through the host). Each rank builds Theia-Base cddsv from one
seed and takes its ``rows`` of a seeded global batch of 2 x ``rows``:

  - at the production recipe (bf16 compute, ``fast_math``, fused
    preprocessing, bf16 Adam moments), ``steps`` train steps with
    ``grad_allreduce_dtype`` bf16, then as many from the same start with the
    float32 wire: the losses, each step's time and its gradient
    all-reduce's (CUDA events; the all-reduce includes gloo's host
    staging), the kernels' launches, and whether the two ranks' parameters
    and Adam moments are bit-equal after the last step;
  - in exact mode (float32 compute), one step with each wire: whether the
    all-reduced gradient is bit for bit the sum, in the wire dtype, of the
    two ranks' local gradients each divided by 2 and cast to it (the JAX
    bf16 bucket's rounding; rank 1's local gradient reaches rank 0 by a
    broadcast after the step), and its relative L2 from one process's
    gradient on the whole global batch (plain autograd on rank 0). That
    last gap is more than the sums' order: the student's float32 forward
    is not bitwise repeatable on the card, and the heads' ReLUs flip where
    a pre-activation lies within rounding of 0 (PERF.md §6).

Each rank writes ``DIR/rank<r>.json``. ``global_batch`` and ``build_model``
are shared with the caller, which holds the losses to a one-process run on
the whole batch.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

MODEL = "theaiinstitute/theia-base-patch16-224-cddsv"
SEED = 31
LR = 1e-4
RECIPE = dict(dtype=torch.bfloat16, fast_math=True, fuse_preprocessing=True)
EXACT = dict(dtype=torch.float32)


def global_batch(rows: int, device: torch.device | str = "cuda") -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """The seeded global batch of ``rows`` uint8 224² images and the cddsv
    teachers' raw bf16 [B, C, H, W] features."""
    from theia_tpu_torch.foundation.common import get_model_feature_size
    from theia_tpu_torch.models.hub import parse_model_name

    _, teachers = parse_model_name(MODEL)
    rng = np.random.default_rng(SEED)
    images = torch.from_numpy(rng.integers(0, 256, (rows, 224, 224, 3), dtype=np.uint8)).to(device)
    targets = {t: torch.from_numpy(rng.standard_normal((rows, *get_model_feature_size(t, keep_spatial=True)),
                                                       dtype=np.float32)).to(device, torch.bfloat16)
               for t in teachers}
    return images, targets


def translator_kwargs(translator: str) -> dict:
    """A translator's kwargs as ``configs/model/translator/<translator>.yaml`` sets them."""
    import yaml

    path = Path(__file__).resolve().parent.parent / "configs" / "model" / "translator" / f"{translator}.yaml"
    return dict(yaml.safe_load(path.read_text()).get("kwargs") or {})


def build_model(flags: dict, device: torch.device | str = "cuda", translator: str = "lconv"):
    """Theia-Base cddsv with ``translator`` at its config's widths from the
    seed, float32 params, in train mode, with its masked AdamW (bf16
    moments at the recipe) and TrainState."""
    from theia_tpu_torch.models.hub import build_theia
    from theia_tpu_torch.train.optim import make_optimizer
    from theia_tpu_torch.train.state import TrainState

    model = build_theia(MODEL, device=device, generator=torch.Generator().manual_seed(SEED), translator=translator,
                        translator_kwargs=translator_kwargs(translator), **flags).train()
    moments = torch.bfloat16 if flags.get("fast_math") else None
    tx = make_optimizer(LR, weight_decay=0.01, moment_dtype=moments)
    return model, tx, TrainState.create(dict(model.named_parameters()), tx)


def launch_counts() -> dict[str, int]:
    from theia_tpu_torch.ops import attention, fused_loss, ln_pallas

    return {"mha_fwd": attention.MHA_FWD_LAUNCHES, "mha_bwd": attention.MHA_BWD_LAUNCHES,
            "ln_bwd_stats": ln_pallas.LN_BWD_STATS_LAUNCHES, "ln_bwd_dx": ln_pallas.LN_BWD_DX_LAUNCHES,
            "loss_sums_fwd": fused_loss.LOSS_SUMS_FWD_LAUNCHES, "loss_sums_bwd": fused_loss.LOSS_SUMS_BWD_LAUNCHES}


def _same_on_both_ranks(tensors: list[torch.Tensor]) -> bool:
    """True if rank 1's tensors equal rank 0's bit for bit (broadcast and compared on rank 1)."""
    ok = True
    for t in tensors:
        mine = t.detach().reshape(-1)
        theirs = mine.clone()
        dist.broadcast(theirs, 0)
        ok = ok and torch.equal(mine, theirs)
    flag = torch.tensor([int(ok)], device=tensors[0].device)
    dist.all_reduce(flag, op=dist.ReduceOp.MIN)
    return bool(flag.item())


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--rows", type=int, default=8)
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args(argv)

    from theia_tpu_torch.models.losses import get_loss, main_loss_from_terms
    from theia_tpu_torch.parallel.distributed import init_distributed
    from theia_tpu_torch.train import step as tstep

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_distributed("cuda", backend="gloo")
    assert world == 2, f"two ranks, got {world}"
    images, targets = global_batch(world * args.rows, device)
    rows = slice(rank * args.rows, (rank + 1) * args.rows)
    mine = (images[rows], {t: v[rows] for t, v in targets.items()})

    spans: list[tuple[torch.cuda.Event, torch.cuda.Event]] = []
    seen: list[tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]] = []  # (local, all-reduced) a step
    all_reduce_grads = tstep.all_reduce_grads

    def timed(grads, world, wire):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = all_reduce_grads(grads, world, wire)
        end.record()
        spans.append((start, end))
        seen.append((grads, out))
        return out

    tstep.all_reduce_grads = timed
    record: dict = {"rank": rank, "device": str(device), "rows": args.rows, "backend": dist.get_backend()}
    try:
        for wire in ("bfloat16", "float32"):
            model, tx, state = build_model(RECIPE, device)
            step = tstep.make_train_step(model, tx, grad_allreduce_dtype=getattr(torch, wire))
            before = launch_counts()
            losses, step_ms = [], []
            spans.clear()
            for _ in range(args.steps):
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record()
                state, metrics = step(state, *mine)
                end.record()
                losses.append(metrics["loss"])
                torch.cuda.synchronize()
                step_ms.append(start.elapsed_time(end))
                seen.clear()
            after = launch_counts()
            opt = state.opt_state
            record[wire] = dict(
                losses=[float(x) for x in losses], step_ms=step_ms,
                allreduce_ms=[s.elapsed_time(e) for s, e in spans],
                launches={k: after[k] - before[k] for k in after},
                n_params=sum(p.numel() for p in state.params.values()),
                params_equal=_same_on_both_ranks(list(state.params.values())),
                moments_equal=_same_on_both_ranks([*opt.mu.values(), *opt.nu.values()]),
            )
            del model, tx, state, step
            torch.cuda.empty_cache()

        # exact mode: one step's all-reduced gradient against the ranks' local
        # gradients, and against the whole batch's in one process
        whole = None
        if rank == 0:
            model, _, _ = build_model(EXACT, device)
            params = list(model.parameters())
            loss = main_loss_from_terms(get_loss(model(images), tstep.prepare_targets(targets)), "cos_l1")
            found = torch.autograd.grad(loss, params, allow_unused=True)
            whole = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1) for p, g in zip(params, found)])
            del model, params, loss, found
        for wire in ("bfloat16", "float32"):
            dtype = getattr(torch, wire)
            model, tx, state = build_model(EXACT, device)
            step = tstep.make_train_step(model, tx, grad_allreduce_dtype=dtype)
            seen.clear()
            state, metrics = step(state, *mine)
            local, out = (torch.cat([g.reshape(-1).float() for g in tree.values()]) for tree in seen[0])
            seen.clear()
            theirs = local.clone()
            dist.broadcast(theirs, 1)  # rank 1's local gradient, on every rank
            if rank == 0:
                want = ((local / world).to(dtype) + (theirs / world).to(dtype)).float()
                record[f"exact_{wire}"] = dict(
                    loss=float(metrics["loss"]), wire_bit_equal=torch.equal(out, want),
                    wire_max_abs=float((out - want).abs().max()),
                    grad_rel_l2_whole=float((out.double() - whole.double()).norm() / whole.double().norm()))
            del model, tx, state, step, local, out, theirs
            torch.cuda.empty_cache()
    finally:
        tstep.all_reduce_grads = all_reduce_grads
    args.out.mkdir(parents=True, exist_ok=True)
    (args.out / f"rank{rank}.json").write_text(json.dumps(record))
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
