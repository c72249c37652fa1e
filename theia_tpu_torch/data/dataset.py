"""Host-side streaming input pipeline over webdataset-format shards (port of theia_tpu/data/dataset.py).

Redesign of the reference pipeline (reference: src/theia/dataset/data_utils.py)
that the JAX package made and the port keeps:

- The reference builds an independent WebDataset per column (image + one per
  teacher), mixes each column separately with identically-seeded RNGs, and
  zips loaders relying on implicit ordering (data_utils.py:405-591). Here
  columns are zipped FIRST with an explicit sample-key assertion, and mixing
  happens once at the sample level — same distribution, no silent
  misalignment.
- Shards are split by (rank, world_size) with path padding
  (data_utils.py:383-402), mirroring wds.split_by_node.
- Batches are dicts of CPU tensors {"image": uint8 [B,H,W,C], teacher:
  {"embedding": [B,H*W,C] bf16 | "embedding_chw": [B,C,H,W] bf16, "cls":
  [B,C]}}, pinned when asked so the copies to the card can be
  asynchronous, made by a background prefetch thread; shards are decoded
  in that thread or, with ``num_workers``, in worker processes
  (``data/parallel_loader.py``).

The random draws (numpy ``RandomState`` streams in the mix, the shard order
and the shuffle buffer) are the JAX package's, so one seed gives the same
batches in the same order in both packages.
"""

from __future__ import annotations

import glob
import math
import os
import queue
import threading
from collections import OrderedDict
from typing import Any, Callable, Generator, Iterable, Iterator, Literal, Optional

import numpy as np
import torch

from theia_tpu_torch.data.stats import load_feature_stats, normalize_feature
from theia_tpu_torch.data.webdataset import ShardIndex, decode_image_npy, load_safetensors, read_splits


def normalize_ds_weights_by_ds_len(
    weights: list[float], lengths: list[int]
) -> tuple[list[float], float | Literal[0]]:
    """Weights proportional to weight*length (data_utils.py:34-49)."""
    expected = [w * l for w, l in zip(weights, lengths)]
    total = sum(expected)
    if total == 0:
        raise ValueError("Sum of dataset length is 0.")
    return [l / total for l in expected], total


def pad_shard_paths(shard_paths: list[str], num_parts: int) -> list[str]:
    """Repeat shard paths cyclically until len % num_parts == 0
    (semantics of reference pad_shard_paths, data_utils.py:383-402)."""
    paths = list(shard_paths)
    n = len(paths)
    if n == 0:
        return paths
    while len(paths) % num_parts != 0:
        paths.append(shard_paths[len(paths) % n])
    return paths


class RandomMix:
    """Probability-weighted interleave of sample iterators
    (reference data_utils.py:85-134), with numpy seeded RNG."""

    def __init__(
        self,
        datasets: list[Iterable],
        probs: Optional[list[float]] = None,
        stopping_strategy: str = "all_exhausted",
        seed: int = 0,
    ) -> None:
        self.datasets = datasets
        self.probs = list(probs) if probs is not None else [1.0] * len(datasets)
        self.stopping_strategy = stopping_strategy
        self.seed = seed

    def split(self, n: int) -> list["RandomMix"]:
        """Disjoint sub-mixes for n loader workers (wds.split_by_worker
        analogue): each member splits its shard list round-robin; worker w
        mixes its sub-members with a derived seed."""
        member_parts = [d.split(n) for d in self.datasets]
        return [
            RandomMix(
                [parts[w] for parts in member_parts],
                probs=self.probs,
                stopping_strategy=self.stopping_strategy,
                seed=self.seed * 1000003 + w,
            )
            for w in range(n)
        ]

    def __iter__(self) -> Generator:
        sources = [iter(d) for d in self.datasets]
        probs = self.probs[:]
        rng = np.random.RandomState(self.seed)
        cum = (np.asarray(probs) / np.sum(probs)).cumsum()
        while sources:
            i = int(np.searchsorted(cum, rng.rand()))
            i = min(i, len(sources) - 1)
            try:
                yield next(sources[i])
            except StopIteration:
                if self.stopping_strategy == "all_exhausted":
                    del sources[i]
                    del probs[i]
                    if not sources:
                        break
                    cum = (np.asarray(probs) / np.sum(probs)).cumsum()
                else:
                    break


def _decode_feature(
    fields: dict[str, Any],
    mean: Optional[torch.Tensor],
    std: Optional[torch.Tensor],
    model: Optional[str] = None,
    raw: bool = False,
) -> dict[str, torch.Tensor]:
    """safetensors bytes -> {"embedding": [H*W, C], "cls": [C]} with optional
    normalization (reference decode_sample; data_utils.py:151-161).

    ``model`` selects the right field in packed shards where one sample holds
    image + several per-teacher safetensors members.

    ``raw=True`` (``feature_norm: device``) ships the stored [C, H, W] bf16
    view as "embedding_chw": the train step transposes and normalizes it on
    the card (``train.step.prepare_targets``)."""
    if model is not None:
        want = f"{model.replace('/', '_')}.safetensors"
        if want not in fields:
            # No silent fallback: in a packed shard holding several teachers,
            # grabbing "any .safetensors field" would silently mis-assign a
            # distillation target. Fail like the key-join path does.
            raise KeyError(
                f"feature member {want!r} not found in sample "
                f"(available fields: {sorted(fields)}) — shard layout must "
                f"store one '<key>.<model>.safetensors' member per teacher"
            )
        blob = fields[want]
    else:
        blob = next(iter(fields.values()))
    sft = load_safetensors(blob)
    emb = sft["embedding"]  # [C, H, W]
    if raw:
        out = {"embedding_chw": emb}
        if "cls_token" in sft:
            out["cls"] = sft["cls_token"]
        return out
    c = emb.shape[0]
    emb = normalize_feature(emb.reshape(c, -1).t(), mean, std)  # (h w) c
    out = {"embedding": emb.contiguous()}
    if "cls_token" in sft:
        out["cls"] = normalize_feature(sft["cls_token"], mean, std)
    return out


class _ZippedShardSet:
    """One dataset member: iterate image + per-teacher feature shards in
    lockstep, key-joined with explicit assertion."""

    def __init__(
        self,
        image_shards: list[str],
        feature_shards: dict[str, list[str]],  # model -> shard paths (aligned)
        stats: Optional[tuple[dict, dict]] = None,
        image_transform: Optional[Callable] = None,
        raw_features: bool = False,
    ) -> None:
        self.image_shards = image_shards
        self.feature_shards = feature_shards
        self.stats = stats
        self.image_transform = image_transform
        self.raw_features = raw_features
        for model, paths in feature_shards.items():
            if len(paths) != len(image_shards):
                raise ValueError(
                    f"column {model} has {len(paths)} shards but images have "
                    f"{len(image_shards)} — columns must align 1:1"
                )

    def split(self, n: int) -> list["_ZippedShardSet"]:
        """Round-robin the (aligned) shard lists over n workers; columns stay
        aligned because every column is sliced with the same stride."""
        return [
            _ZippedShardSet(
                self.image_shards[w::n],
                {m: paths[w::n] for m, paths in self.feature_shards.items()},
                self.stats,
                self.image_transform,
                self.raw_features,
            )
            for w in range(n)
        ]

    def __iter__(self) -> Generator[dict[str, Any], None, None]:
        models = list(self.feature_shards)
        for si in range(len(self.image_shards)):
            img_iter = ShardIndex(self.image_shards[si]).samples()
            feat_iters = {m: ShardIndex(self.feature_shards[m][si]).samples() for m in models}
            for key, img_fields in img_iter:
                sample: dict[str, Any] = {}
                image = decode_image_npy(img_fields["image"])
                if self.image_transform is not None:
                    image = self.image_transform(image)
                sample["image"] = image
                ok = True
                for m in models:
                    try:
                        fkey, ffields = next(feat_iters[m])
                    except StopIteration:
                        ok = False
                        break
                    if fkey != key:
                        raise ValueError(
                            f"column misalignment in shard {si}: image key {key!r} "
                            f"vs {m} key {fkey!r} (the reference silently zips by "
                            f"order; we key-join explicitly)"
                        )
                    if self.stats is not None:
                        mean, std = self.stats[0].get(m), self.stats[1].get(m)
                    else:
                        mean = std = None
                    sample[m] = _decode_feature(ffields, mean, std, model=m, raw=self.raw_features)
                if ok:
                    yield sample


def get_image_video_dataset(
    dataset_root: str,
    feature_models: list[str],
    dataset_mix: Optional[str | dict[str, float] | list] = None,
    split: str = "train",
    dataset_ratio: float = 1.0,
    image_transform: Optional[Callable] = None,
    feature_norm: bool | str = False,
    stats_root: Optional[str] = None,
    seed: int = 0,
    shuffle: bool = False,
    rank: int = 0,
    world_size: int = 1,
    **kwargs: Any,
) -> tuple[RandomMix, float]:
    """Build the mixed frame-level dataset (reference data_utils.py:405-528).

    Returns (iterable over sample dicts, expected total length). ``rank`` /
    ``world_size`` pick a disjoint shard subset, mirroring wds.split_by_node.
    """
    if isinstance(dataset_mix, dict):
        dataset_mix = OrderedDict(**dataset_mix)
    elif isinstance(dataset_mix, (list, tuple)):
        dataset_mix = OrderedDict({d: 1.0 for d in dataset_mix})
    elif isinstance(dataset_mix, str):
        from theia_tpu_torch.data.oxe import OXE_NAMED_MIXES

        if dataset_mix not in OXE_NAMED_MIXES:
            raise ValueError(f"unknown dataset mix {dataset_mix}")
        dataset_mix = OrderedDict({k: v for k, v in OXE_NAMED_MIXES[dataset_mix]})
    else:
        raise ValueError(f"dataset_mix of {dataset_mix}:{type(dataset_mix)} is not supported.")

    if split in ("eval", "val"):
        dataset_mix = OrderedDict({d: 1.0 for d in dataset_mix})

    # feature_norm: True = normalize on the host in bf16 (reference semantics;
    # data_utils.py:498-503); "device" = ship the raw bf16 [C, H, W] buffers
    # and normalize in the train step on the card
    raw_features = feature_norm == "device"
    stats = None
    if feature_norm and not raw_features:
        stats = load_feature_stats(stats_root or dataset_root, feature_models)

    members: list[_ZippedShardSet] = []
    weights: list[float] = []
    lengths: list[int] = []
    shard_rng = np.random.RandomState(seed)

    for d in dataset_mix:
        dataset_len = read_splits(os.path.join(dataset_root, d))[split]
        if dataset_len == 0:
            continue

        image_paths = sorted(glob.glob(os.path.join(dataset_root, d, "images", f"*-{split}.tar")))
        if not image_paths:
            raise FileNotFoundError(f"no image shards for {d} split {split} under {dataset_root}")
        n = len(image_paths)
        order = np.arange(n)
        if shuffle:
            shard_rng.shuffle(order)  # detshuffle: same permutation on all ranks

        def _column(paths: list[str]) -> list[str]:
            padded = pad_shard_paths([paths[i] for i in order], world_size)
            return padded[rank::world_size]

        image_shards = _column(image_paths)
        feature_shards = {}
        for m in feature_models:
            mpaths = sorted(glob.glob(os.path.join(dataset_root, d, m.replace("/", "_"), f"*-{split}.tar")))
            if len(mpaths) != n:
                raise FileNotFoundError(
                    f"feature column {m} for {d} has {len(mpaths)} shards, images have {n}"
                )
            feature_shards[m] = _column(mpaths)

        members.append(_ZippedShardSet(image_shards, feature_shards, stats, image_transform, raw_features))
        weights.append(dataset_mix[d])
        lengths.append(math.ceil(dataset_len * dataset_ratio))

    norm_weights, expected = normalize_ds_weights_by_ds_len(weights, lengths)
    return RandomMix(members, probs=norm_weights, seed=seed), expected


class _ShuffleBuffer:
    def __init__(self, source: Iterable, size: int, seed: int) -> None:
        self.source = source
        self.size = size
        self.seed = seed

    def __iter__(self) -> Generator:
        rng = np.random.RandomState(self.seed)
        buf: list[Any] = []
        for item in self.source:
            if len(buf) < self.size:
                buf.append(item)
                continue
            i = rng.randint(len(buf))
            buf[i], item = item, buf[i]
            yield item
        rng.shuffle(buf)
        yield from buf


def _stack(tensors: list[torch.Tensor], pin_memory: bool) -> torch.Tensor:
    first = tensors[0]
    out = torch.empty((len(tensors), *first.shape), dtype=first.dtype, pin_memory=pin_memory)
    return torch.stack(tensors, out=out)


def _collate(samples: list[dict[str, Any]], pin_memory: bool = False) -> dict[str, Any]:
    """Stack a list of sample dicts into batched CPU tensors, in page-locked
    memory when ``pin_memory`` (the source of asynchronous copies to the card)."""
    out: dict[str, Any] = {}
    for k, v in samples[0].items():
        if isinstance(v, dict):
            out[k] = {f: _stack([s[k][f] for s in samples], pin_memory) for f in v}
        else:
            out[k] = _stack([s[k] for s in samples], pin_memory)
    return out


class _PrefetchIter:
    """Background-thread prefetch of ready batches (depth-bounded).

    Closeable: ``close()`` unblocks the producer thread and closes the
    source generator. Without this, an iterator abandoned mid-pass — which
    the train loop does at the end of every epoch — left the producer
    blocked in ``q.put`` holding the source alive."""

    def __init__(self, source: Iterator, depth: int = 4, owner: Any = None) -> None:
        self._source = source
        # strong backref: the owning loader must outlive this iterator. The
        # batches generator is the only other reference to the loader, and
        # its frame clears the moment it finishes — without this backref a
        # loader the caller didn't bind (``for b in get_frame_dataloader(...)``)
        # could hit refcount 0 ON THE PRODUCER THREAD mid-pass, and its
        # __del__'s close() would drain still-unconsumed batches + the
        # sentinel: the tail of the pass silently lost, or a consumer already
        # blocked in q.get() hung forever.
        self._owner = owner
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._sentinel = object()
        self._stop = threading.Event()
        self._closed = False
        self._err: list[BaseException] = []
        self._t = threading.Thread(target=self._produce, daemon=True)
        self._t.start()

    def _produce(self) -> None:
        try:
            for item in self._source:
                placed = False
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.2)
                        placed = True
                        break
                    except queue.Full:
                        continue
                if not placed:
                    break
        except BaseException as e:  # propagate into consumer
            self._err.append(e)
        finally:
            close = getattr(self._source, "close", None)
            if close is not None:
                try:
                    close()
                except BaseException:
                    pass
            # deliver the sentinel reliably on normal completion (the queue
            # may be full of unconsumed batches); give up only when closed —
            # then the consumer is gone and nothing waits on it
            while not self._stop.is_set():
                try:
                    self._q.put(self._sentinel, timeout=0.2)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        self._closed = True
        self._stop.set()
        # drain so a producer blocked on a full queue can observe the stop
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._t is not threading.current_thread():
            self._t.join(timeout=5)

    def __iter__(self) -> "_PrefetchIter":
        return self

    def __next__(self) -> Any:
        # after close() the drained queue never receives a sentinel (the
        # producer skips delivery once _stop is set) — a blocking get would
        # hang forever; stale iterators must terminate instead. The timed
        # get re-checks on every tick so a close() that lands while we are
        # ALREADY blocked also terminates us instead of deadlocking.
        while True:
            if self._closed:
                raise StopIteration
            try:
                item = self._q.get(timeout=0.5)
                break
            except queue.Empty:
                if not self._t.is_alive() and self._q.empty():
                    # producer gone without a sentinel (raced a close)
                    raise StopIteration
                continue
        if item is self._sentinel:
            if self._err:
                raise self._err[0]
            raise StopIteration
        return item


class _BatchedLoader:
    """Re-iterable batched loader: every ``iter()`` builds a fresh batch
    generator + prefetch thread over the (re-iterable) sample source, so
    ``iter(loader)`` after exhaustion starts a new pass — the train loop
    re-iterates when an epoch needs more batches than one pass yields.
    Starting a new pass closes the previous pass's prefetcher."""

    def __init__(self, source: Iterable, batch_size: int, drop_last: bool, prefetch: int,
                 pin_memory: bool = False) -> None:
        self.source = source
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pin_memory = pin_memory
        self._active: Optional[_PrefetchIter] = None

    def _batches(self) -> Generator:
        buf: list = []
        for sample in self.source:
            buf.append(sample)
            if len(buf) == self.batch_size:
                yield _collate(buf, self.pin_memory)
                buf = []
        if buf and not self.drop_last:
            yield _collate(buf, self.pin_memory)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        if self._active is not None:
            self._active.close()
        self._active = _PrefetchIter(self._batches(), depth=self.prefetch, owner=self)
        return self._active

    def __del__(self) -> None:  # pragma: no cover - GC timing
        try:
            if getattr(self, "_active", None) is not None:
                self._active.close()
        except BaseException:
            # __del__ may run during interpreter teardown where threading/
            # queue internals are already gone; cleanup is best-effort here
            pass


def get_frame_dataloader(
    dataset: Iterable,
    batch_size: int,
    shuffle: bool = False,
    shuffle_buffer_size: int = 1000,
    seed: int = 0,
    prefetch: int = 4,
    drop_last: bool = True,
    num_workers: int = 0,
    worker_ordered: bool = True,
    worker_transport: str = "shm",
    pin_memory: bool = False,
    **kwargs: Any,
) -> Iterable[dict[str, Any]]:
    """Batched loader with shuffle-after-mix buffer (data_utils.py:531-556).

    ``num_workers > 0`` decodes shards in worker processes
    (``data/parallel_loader.py``; the analogue of
    wds.WebLoader(num_workers=...)): ``worker_ordered=False`` merges worker
    samples as they complete (no stall on a slow worker; order not fixed),
    ``worker_transport`` is "shm" (a shared-memory ring a worker; "queue"
    where /dev/shm is too small) or "queue". The shuffle buffer, batching
    and the prefetch thread stay in the calling process. ``pin_memory``
    collates into page-locked memory for ``non_blocking`` copies to the card.
    """
    if num_workers > 0:
        from theia_tpu_torch.data.parallel_loader import ParallelSampleSource

        dataset = ParallelSampleSource(dataset, num_workers=num_workers, ordered=worker_ordered,
                                       transport=worker_transport)
    source: Iterable = dataset
    if shuffle:
        source = _ShuffleBuffer(source, shuffle_buffer_size, seed)
    return _BatchedLoader(source, batch_size, drop_last, prefetch, pin_memory)
