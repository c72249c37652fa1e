"""Training orchestration: epochs, eval, checkpoints, metrics (port of theia_tpu/train/loop.py).

One process drives the train step (``train/step.py``) on one device; the
host loop streams batches from pinned memory, rolls teacher subsets,
throttles metric readback and saves checkpoints with true resume (the
reference saves weights only: src/theia/scripts/train/train_rvfm.py:38-345).
The epoch, step, eval and fast-forward arithmetic is the JAX loop's at one
process. Left out with the JAX package's mesh: ``model_axis > 1`` (tensor
parallelism) and more than one process (``WORLD_SIZE > 1``; data parallelism
is ROADMAP Queue 1 #5) raise; ``donate_state`` has no meaning here.
"""

from __future__ import annotations

import math
import os
import random
import time
from typing import Any, Callable, Optional

import torch

from theia_tpu_torch.config import DotDict, to_yaml
from theia_tpu_torch.data.dataset import get_frame_dataloader, get_image_video_dataset
from theia_tpu_torch.data.stats import load_feature_stats
from theia_tpu_torch.foundation.common import MODEL_FEATURE_SIZES, get_model_feature_size
from theia_tpu_torch.models.rvfm import Theia
from theia_tpu_torch.train.checkpoint import CheckpointSession, restore_checkpoint
from theia_tpu_torch.train.optim import (
    constant_with_warmup,
    cosine_restarts_with_warmup,
    make_optimizer,
    scaled_lr,
)
from theia_tpu_torch.train.state import TrainState
from theia_tpu_torch.train.step import make_eval_step, make_train_step
from theia_tpu_torch.utils.logging import MetricLogger, create_meters, update_meters_from_metrics
from theia_tpu_torch.utils.seed import seed_everything


def _parse_grad_allreduce_dtype(value: Any) -> Optional[torch.dtype]:
    """training.grad_allreduce_dtype -> dtype or None, rejecting typos loudly.
    One process has no gradient all-reduce, so the value is only validated."""
    if value in (None, "float32", "f32"):
        return None
    if value in ("bfloat16", "bf16"):
        return torch.bfloat16
    raise ValueError(
        f"training.grad_allreduce_dtype={value!r} not supported: use "
        "'float32' (exact wire) or 'bfloat16' (half the DP all-reduce bytes)"
    )


def select_target_models(cfg: DotDict) -> tuple[list[str], list[str], dict[str, tuple[int, ...]]]:
    """Teacher selection incl. optional `<t>_cls` targets
    (reference train_rvfm.py:230-246). Returns (all names, names w/o _cls,
    target feature sizes)."""
    names = list(cfg.training.target_models.target_model_names or [])
    if not names:
        names = list(MODEL_FEATURE_SIZES.keys())
    names = [t for t in names if "llava" not in t]
    sizes = {t: get_model_feature_size(t, keep_spatial=True) for t in names}
    names_wocls = names[:]
    if cfg.training.get("distill_cls", False):
        for t in names_wocls:
            if "google/vit" in t or "facebook/dino" in t or "openai/clip" in t:
                sizes[t + "_cls"] = sizes[t][:1]
                names.append(t + "_cls")
    return names, names_wocls, sizes


def resolve_num_workers(cfg: DotDict) -> int:
    """Loader-worker count: ``dataset.num_workers`` is the operative knob
    (0 = in-process decode). A reference config ported verbatim carries
    ``training.num_workers`` instead (reference data_utils.py:531-556) —
    honored as an alias, capped at cpu_count-1. A count above 0 decodes the
    train split in that many worker processes (``data/parallel_loader.py``)."""
    if "num_workers" in cfg.dataset:
        return int(cfg.dataset.get("num_workers", 0) or 0)
    legacy = int(cfg.training.get("num_workers", 0) or 0)
    if legacy <= 0:
        return 0
    cap = max(0, (os.cpu_count() or 1) - 1)
    n = min(legacy, cap)
    print(
        f"[theia_tpu_torch] training.num_workers={legacy} aliased to loader "
        f"num_workers={n} (capped at cpu_count-1={cap}; set "
        f"dataset.num_workers explicitly to override)"
    )
    return n


def build_run_identifier(cfg: DotDict) -> str:
    """rvfm_dp<ratio>_<backbone>_<translator>[_pretrained]_<notes>
    (reference train_rvfm.py:336-341)."""
    backbone = f"_{cfg.model.backbone.backbone.replace('/', '-')}"
    notes = f"_{cfg.logging.notes}" if cfg.logging.notes else ""
    translator = f"_{cfg.model.translator.type}"
    pretrained = "_pretrained" if cfg.model.backbone.get("pretrained") else ""
    dp = f"_dp{cfg.dataset.dataset_ratio:.3f}"
    return f"rvfm{dp}{backbone}{translator}{pretrained}{notes}"


def build_lr_schedule(cfg: DotDict, lr: float, total_steps: int, warmup_steps: int) -> Callable:
    name = cfg.training.lr_scheduler.get("name", "constant_with_warmup")
    start = float(cfg.training.lr_scheduler.get("warm_up_lr_start_factor", 1e-2))
    if name == "constant_with_warmup":
        return constant_with_warmup(lr, warmup_steps, start)
    if name == "cosine_restarts_with_warmup":
        return cosine_restarts_with_warmup(lr, warmup_steps, max(total_steps - warmup_steps, 1), start)
    raise NotImplementedError(f"lr_scheduler {name}")


def _targets_from_batch(batch: dict, target_model_names: list[str]) -> dict[str, torch.Tensor]:
    """batch[teacher]["embedding"/"cls"] -> target dict
    (reference train_rvfm.py:107-114). "embedding_chw" carries raw bf16
    buffers in feature_norm="device" mode."""
    out = {}
    for t in target_model_names:
        base = t.replace("_cls", "")
        if "_cls" in t:
            out[t] = batch[base]["cls"]
        else:
            fields = batch[base]
            out[t] = fields.get("embedding_chw", fields.get("embedding"))
    return out


def _tree_add(a: Any, b: Any) -> Any:
    if isinstance(a, dict):
        return {k: _tree_add(v, b[k]) for k, v in a.items()}
    return a + b


def _fetch_mean(tree: dict, n: int) -> dict:
    """``tree`` / n read back to the host in one device-to-host copy."""
    keys: list[tuple] = []
    leaves: list[torch.Tensor] = []

    def walk(node: dict, path: tuple) -> None:
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
            else:
                keys.append(path + (k,))
                leaves.append(v.float())

    walk(tree, ())
    values = (torch.stack(leaves) / n).cpu().tolist()
    out: dict = {}
    for path, v in zip(keys, values):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def build_model(cfg: DotDict, device: torch.device | str, generator: Optional[torch.Generator] = None) -> Theia:
    """The student the config describes (loop.py:150-161 of the JAX package):
    created without storage, every parameter drawn on the CPU from
    ``generator`` (by default one seeded with ``cfg.seed``), then moved to
    ``device`` in float32; ``training.compute_dtype`` is the compute dtype.
    ``model.backbone.pretrained`` is carried as the JAX package carries it:
    it loads no weights and shows only in the run identifier."""
    _, _, target_sizes = select_target_models(cfg)
    dtype = torch.bfloat16 if cfg.training.get("compute_dtype", "bfloat16") == "bfloat16" else torch.float32
    with torch.device("meta"):
        model = Theia(
            backbone=cfg.model.backbone.backbone,
            pretrained=bool(cfg.model.backbone.get("pretrained", False)),
            translator=cfg.model.translator.type,
            translator_kwargs=dict(cfg.model.translator.get("kwargs", {}) or {}),
            target_feature_sizes=target_sizes,
            num_reg_tokens=int(cfg.model.backbone.get("num_reg_tokens", 7) or 7),
            dtype=dtype,
            fuse_preprocessing=bool(cfg.training.get("fuse_preprocessing", False)),
            fast_math=bool(cfg.training.get("fast_math", False)),
        )
    model.to_empty(device="cpu")
    model.reset_parameters(generator if generator is not None else torch.Generator().manual_seed(int(cfg.seed)))
    return model.to(device)


def build_optimizer(cfg: DotDict, learning_rate: float | Callable):
    """The config's masked AdamW (``training.moment_dtype: bfloat16`` stores the moments in bf16)."""
    return make_optimizer(
        learning_rate,
        weight_decay=float(cfg.training.weight_decay),
        betas=tuple(cfg.training.optimizer.get("betas", (0.9, 0.999))),
        eps=float(cfg.training.optimizer.get("eps", 1e-8)),
        translator_lr_factor=float(cfg.training.get("translator_lr_factor", 1.0)),
        moment_dtype=torch.bfloat16 if cfg.training.get("moment_dtype", None) == "bfloat16" else None,
    )


def _check_single_process(cfg: DotDict) -> None:
    if int(cfg.training.get("model_axis", 1) or 1) > 1:
        raise NotImplementedError(
            f"training.model_axis={cfg.training.model_axis}: tensor parallelism (theia_tpu/parallel/tp.py) is not "
            "ported; the port trains on one device"
        )
    world = int(os.environ.get("WORLD_SIZE", "1") or 1)
    if world > 1:
        raise NotImplementedError(
            f"WORLD_SIZE={world}: data parallelism over processes is not ported yet (ROADMAP Queue 1 #5, DDP)"
        )
    _parse_grad_allreduce_dtype(cfg.training.get("grad_allreduce_dtype", None))


def train_from_config(
    cfg: DotDict, resume: bool = True, max_steps: Optional[int] = None, device: torch.device | str = "cuda"
) -> dict:
    """Full training entry (reference ddp_main + train; train_rvfm.py:221-345).

    Trains on ``device``: the GPU unless the caller asks for the CPU.
    Returns a summary dict (final step, last losses; the JAX loop's keys)
    with, under "timing", the host's view of this call: the epoch loop's
    wall time (train steps, evals and saves, ending after the final blocking
    save, which waits for the device), the steps and images it trained, the
    time blocked in the loaders' ``next()``, each save's (step, seconds
    ``save()`` blocked, seconds its write took) and the restore's seconds.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("train_from_config: no CUDA device; pass device='cpu' to train on the CPU")
    _check_single_process(cfg)
    if not cfg.logging.get("run_identifier_prefix"):
        cfg.logging.run_identifier_prefix = build_run_identifier(cfg)
    _, generator = seed_everything(cfg.seed)

    target_model_names, names_wocls, _ = select_target_models(cfg)
    model = build_model(cfg, device, generator)

    feature_norm = cfg.dataset.feature_norm
    target_stats = None
    if feature_norm == "device":
        means, stds = load_feature_stats(
            cfg.dataset.get("stats_root") or cfg.dataset.dataset_root, names_wocls, dtype=torch.float32
        )
        target_stats = {}
        for t in target_model_names:
            base = t.replace("_cls", "")
            target_stats[t] = (means[base].to(device), stds[base].to(device))

    mix_cfg = cfg.dataset.dataset_mix
    mix = mix_cfg if isinstance(mix_cfg, str) else list(mix_cfg)
    if cfg.dataset.get("type", "image_video") == "oxe":
        # OXE robot-data mixes (reference configs/dataset/oxe_octo_mix.yaml +
        # dataset/oxe/oxe_mixes.py): packed per-view shards, named mixes
        from theia_tpu_torch.data.oxe import get_oxe_frame_dataset

        ds_kwargs = dict(dataset_root=cfg.dataset.dataset_root, dataset_mix=mix, feature_models=names_wocls,
                         image_views=cfg.dataset.get("image_views"), seed=cfg.seed)
        train_ds, train_len = get_oxe_frame_dataset(
            split="train", dataset_ratio=cfg.dataset.dataset_ratio, shuffle=cfg.dataset.shuffle, **ds_kwargs
        )
        eval_ds, eval_len = get_oxe_frame_dataset(split="val", dataset_ratio=0.1, shuffle=False, **ds_kwargs)
    else:
        ds_kwargs = dict(dataset_root=cfg.dataset.dataset_root, dataset_mix=mix, feature_models=names_wocls,
                         feature_norm=feature_norm, stats_root=cfg.dataset.get("stats_root"), seed=cfg.seed)
        train_ds, train_len = get_image_video_dataset(
            split="train", dataset_ratio=cfg.dataset.dataset_ratio, shuffle=cfg.dataset.shuffle, **ds_kwargs
        )
        eval_ds, eval_len = get_image_video_dataset(split="val", dataset_ratio=0.1, shuffle=False, **ds_kwargs)

    # one process on one device: the JAX loop's step arithmetic (train_rvfm.py:294-301)
    # with one data shard; eval keeps its partial tail batch
    batch_size = int(cfg.training.batch_size)
    train_epoch_steps = math.ceil(train_len / batch_size)
    eval_epoch_steps = math.ceil(eval_len / batch_size)
    if max_steps is not None:
        train_epoch_steps = min(train_epoch_steps, max_steps)
        eval_epoch_steps = min(eval_epoch_steps, max(max_steps // 4, 1))
    total_train_steps = train_epoch_steps * cfg.training.epochs
    warmup_steps = int(cfg.training.warm_up_steps_ratio * total_train_steps)

    lr = scaled_lr(float(cfg.training.base_lr), batch_size, 1,
                   int(cfg.training.base_batch_size), int(cfg.training.base_world_size))
    schedule = build_lr_schedule(cfg, lr, total_train_steps, warmup_steps)
    loss_dtype = torch.bfloat16 if cfg.training.get("loss_dtype", "float32") == "bfloat16" else torch.float32
    tx = build_optimizer(cfg, schedule)
    state = TrainState.create(dict(model.named_parameters()), tx)

    ckpt_dir = os.path.join(cfg.logging.model_path, cfg.logging.run_identifier_prefix)
    restore_s = None
    if resume:
        t0 = time.perf_counter()
        if restore_checkpoint(ckpt_dir, state) is not None:
            restore_s = time.perf_counter() - t0

    train_step = make_train_step(
        model, tx,
        main_loss=cfg.training.main_loss,
        target_loss_weights=cfg.training.target_models.get("target_model_weights"),
        grad_clip=bool(cfg.training.grad_clip),
        grad_clip_norm=float(cfg.training.grad_clip_norm),
        grad_clip_norm_warmup=float(cfg.training.grad_clip_norm_warmup),
        warmup_steps=warmup_steps,
        freeze_translator=bool(cfg.training.freeze_translator),
        freeze_translator_start_step=int(cfg.training.freeze_translator_start_steps_ratio * total_train_steps),
        target_stats=target_stats,
        loss_dtype=loss_dtype,
    )
    eval_step = make_eval_step(
        model,
        main_loss=cfg.training.main_loss,
        target_loss_weights=cfg.training.target_models.get("target_model_weights"),
        target_stats=target_stats,
    )

    logger = MetricLogger(
        cfg.logging.log_path,
        cfg.logging.run_identifier_prefix,
        use_wandb=bool(cfg.logging.get("wandb", False)),
        use_tensorboard=bool(cfg.logging.get("tensorboard", False)),
        project=cfg.logging.project,
        config=cfg.to_dict(),
    )
    print(to_yaml(cfg))

    pin = device.type == "cuda"

    def place(batch: dict) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Pinned host batch -> device tensors, copied asynchronously."""
        targets = _targets_from_batch(batch, target_model_names)
        return (batch["image"].to(device, non_blocking=True),
                {t: v.to(device, non_blocking=True) for t, v in targets.items()})

    loader_wait = 0.0

    def next_batch(it):
        nonlocal loader_wait
        t0 = time.perf_counter()
        try:
            return next(it)
        finally:
            loader_wait += time.perf_counter() - t0

    num_workers = resolve_num_workers(cfg)
    random_targets = int(cfg.training.get("random_target_models", -1))
    log_interval = int(cfg.logging.get("log_interval", 50))
    save_interval = int(cfg.logging.get("save_ckpt_interval", 20000))
    rng = random.Random(cfg.seed)
    mask_on, mask_off = torch.ones((), device=device), torch.zeros((), device=device)

    steps = int(state.step)
    first_step = steps
    # preemption-safe auto-resume: a restored mid-epoch state fast-forwards
    # past the work already done — completed epochs are skipped and the
    # partial epoch runs only its remaining steps (the epoch's loader is
    # restarted from its seeded beginning rather than replayed to the kill
    # point; the reference has no resume at all, SURVEY.md §5)
    start_ep = min(steps // train_epoch_steps, int(cfg.training.epochs)) if train_epoch_steps else 0
    done_in_epoch = steps - start_ep * train_epoch_steps
    if steps:
        print(f"[theia_tpu_torch] resuming at step {steps} (epoch {start_ep}, {done_in_epoch} steps into it)")
    summary: dict[str, Any] = {}
    images_trained = 0
    ckpt_session = CheckpointSession(ckpt_dir)
    t_loop = time.perf_counter()
    for ep in range(start_ep, int(cfg.training.epochs)):
        epoch_steps = train_epoch_steps - (done_in_epoch if ep == start_ep else 0)
        t_start = time.time()  # per-epoch, like images_seen below
        meters = create_meters(target_model_names)
        loader = get_frame_dataloader(
            train_ds,
            batch_size=batch_size,
            shuffle=cfg.dataset.shuffle,
            shuffle_buffer_size=cfg.dataset.shuffle_buffer_size,
            seed=cfg.seed + ep,
            num_workers=num_workers,
            pin_memory=pin,
        )
        train_iter = iter(loader)
        # per-step metrics are summed ON DEVICE and read back once per log
        # window, so avg_train_* are true per-step averages (reference
        # log_metrics semantics) with a single host sync
        window_sum: Optional[dict] = None
        window_steps = 0
        window_images = 0
        images_seen = 0
        for i in range(epoch_steps):
            try:
                batch = next_batch(train_iter)
            except StopIteration:
                train_iter = iter(loader)
                batch = next_batch(train_iter)

            loss_masks = None
            if random_targets > 0:
                chosen = rng.sample(target_model_names, min(2, len(target_model_names)))
                loss_masks = {t: mask_on if t in chosen else mask_off for t in target_model_names}

            images, targets = place(batch)
            state, metrics = train_step(state, images, targets, loss_masks)
            steps += 1
            images_seen += images.shape[0]
            images_trained += images.shape[0]
            window_sum = metrics if window_sum is None else _tree_add(window_sum, metrics)
            window_steps += 1
            window_images += images.shape[0]

            if steps % log_interval == 0:
                fetched = _fetch_mean(window_sum, window_steps)
                flat = update_meters_from_metrics(meters, fetched, target_model_names, "train", window_images)
                flat["lr"] = float(schedule(steps))
                flat["images_per_sec"] = images_seen / max(time.time() - t_start, 1e-9)
                logger.log(flat, steps)
                summary["train"] = flat
                window_sum, window_steps, window_images = None, 0, 0

            if save_interval > 0 and steps % save_interval == 0 and i < epoch_steps - 1:
                # async: copies to host and returns; the write overlaps the next
                # steps. The epoch's last step is saved by the blocking save
                # below (orbax skips a step it has already saved)
                ckpt_session.save(state, steps)

        if window_sum is not None and window_steps > 0:
            # flush the partial tail window so the returned summary always
            # carries the last train-loss even on short runs (max_steps <
            # log_interval)
            fetched = _fetch_mean(window_sum, window_steps)
            flat = update_meters_from_metrics(meters, fetched, target_model_names, "train", window_images)
            flat["lr"] = float(schedule(steps))
            logger.log(flat, steps)
            summary["train"] = flat
            window_sum, window_steps, window_images = None, 0, 0

        # ---- eval epoch (reference train_rvfm.py:159-201) ----
        # partial tail batches are kept (an eval set smaller than one batch
        # must still evaluate); metrics are summed on the device and read
        # back once
        eval_loader = get_frame_dataloader(eval_ds, batch_size=batch_size, shuffle=False, seed=cfg.seed,
                                           drop_last=False, pin_memory=pin)
        eval_iter = iter(eval_loader)
        eval_sum = None
        eval_batches = 0
        eval_images = 0
        for _ in range(eval_epoch_steps):
            try:
                batch = next_batch(eval_iter)
            except StopIteration:
                break
            images, targets = place(batch)
            em = eval_step(images, targets)
            eval_sum = em if eval_sum is None else _tree_add(eval_sum, em)
            eval_batches += 1
            eval_images += images.shape[0]
        if eval_sum is not None:
            fetched = _fetch_mean(eval_sum, eval_batches)
            flat = update_meters_from_metrics(meters, fetched, target_model_names, "eval", eval_images)
            logger.log({k: v for k, v in flat.items() if k.startswith("avg_eval")}, steps)
            summary["eval"] = {k: v for k, v in flat.items() if "eval" in k}

        ckpt_session.save(state, steps, block=True)

    ckpt_session.close()
    wall_s = time.perf_counter() - t_loop
    logger.close()
    summary.update(step=steps, run=cfg.logging.run_identifier_prefix, ckpt_dir=ckpt_dir)
    summary["timing"] = dict(wall_s=wall_s, steps=steps - first_step, images=images_trained,
                             loader_wait_s=loader_wait, saves=[tuple(t) for t in ckpt_session.timings],
                             restore_s=restore_s)
    return summary
