"""Multi-process shard decode for the host input pipeline (port of theia_tpu/data/parallel_loader.py).

The analogue of the reference's ``wds.WebLoader(num_workers=...)``
(reference: src/theia/dataset/data_utils.py:531-556): shard streams are
split round-robin over N worker processes; each worker runs the same tar
read and safetensors decode the in-process path runs, and the parent merges
worker outputs in strict round-robin order, so the sample stream is
deterministic for a fixed (num_workers, seed) and equal to the JAX
package's.

What crosses the process boundary:
  - samples are dicts of CPU tensors, many of them views into a worker's
    copy-on-write mmap of its shard files (``data/webdataset.py``), which
    cannot leave the process. A worker flattens a sample into its tensor
    leaves and a skeleton (non-tensor leaves stay inline) and sends each
    leaf's bytes with its dtype and shape;
  - ``transport="shm"``: the bytes are copied into a free slot of the
    worker's shared-memory ring and only the descriptor crosses the queue;
    the parent copies each leaf out of the slot (a clone: a tensor over the
    ring would pin the slot) and frees it before it yields the sample, so a
    batch never holds a slot and a ring smaller than a batch cannot
    deadlock. Samples larger than ``slot_bytes`` take the queue path;
  - ``transport="queue"``: the bytes are pickled through the queue.

The default context is "forkserver": the parent may hold a CUDA context and
threads, after which fork is unsafe; forkserver needs the dataset parts to
pickle (shard paths and CPU stats, no closures). Programs run from stdin
have no ``__main__`` file for forkserver to re-import and fall back to
"fork".

One fault of the JAX loader is repaired: its sentinel carries no worker
index, and its unordered merge polls every worker, so a worker that had
sent its sentinel and exited 0 was reported dead once another worker was
silent past the poll. Here the sentinel carries the worker's index and the
unordered merge polls only the workers still running.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue as _queue
import sys
import time
import warnings
from typing import Any, Iterable, Iterator, Optional

import torch

_DONE = "__done__"
_ERROR = "__error__"
# seconds a merge waits on a queue before it checks whether the workers it
# waits for are still alive (a module constant, so that a test can shorten it)
WORKER_POLL_S = 5.0
# leaf offsets in a ring slot are multiples of this
_ALIGN = 64


def _flatten_tensors(sample: Any, prefix: tuple = ()) -> tuple[list, Any]:
    """Split a (possibly nested-dict) sample into [(path, tensor)] plus a
    skeleton with tensors replaced by None (non-tensor leaves stay inline)."""
    if isinstance(sample, dict):
        tensors: list = []
        skel = {}
        for k, v in sample.items():
            sub, sub_skel = _flatten_tensors(v, prefix + (k,))
            tensors.extend(sub)
            skel[k] = sub_skel
        return tensors, skel
    if isinstance(sample, torch.Tensor):
        return [(prefix, sample)], None
    return [], sample


def _set_path(skel: Any, path: tuple, value: Any) -> Any:
    """Put ``value`` at ``path`` in ``skel``; returns the sample (``value``
    itself when the sample is one tensor)."""
    if path == ():
        return value
    node = skel
    for k in path[:-1]:
        node = node[k]
    node[path[-1]] = value
    return skel


def _leaf_bytes(t: torch.Tensor) -> torch.Tensor:
    """A tensor's elements as contiguous uint8 (a copy only where it is not contiguous)."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _pack_inline(sample: Any) -> tuple:
    """The queue form of a sample: skeleton and [(path, dtype, shape, bytes)]."""
    tensors, skel = _flatten_tensors(sample)
    return skel, [(path, t.dtype, tuple(t.shape), bytearray(_leaf_bytes(t).numpy())) for path, t in tensors]


def _unpack_inline(payload: tuple) -> Any:
    skel, leaves = payload
    sample = skel
    for path, dtype, shape, data in leaves:
        t = torch.frombuffer(data, dtype=torch.uint8) if data else torch.empty(0, dtype=torch.uint8)
        sample = _set_path(sample, path, t.view(dtype).reshape(shape))
    return sample


def _worker_main(dataset: Any, q: Any, widx: int, shm_name: Optional[str] = None, slot_bytes: int = 0,
                 free_q: Any = None) -> None:
    """Decode loop of worker ``widx``. With the shm transport each sample's
    tensors are copied into a free ring slot and only a small descriptor
    crosses the queue; the sentinel ``(_DONE, widx)`` ends the stream."""
    shm = None
    try:
        if shm_name is not None:
            from multiprocessing import shared_memory

            shm = shared_memory.SharedMemory(name=shm_name)
        for sample in dataset:
            if shm is None:
                q.put(("sample", _pack_inline(sample)))
                continue
            tensors, skel = _flatten_tensors(sample)
            metas, off = [], 0
            for path, t in tensors:
                metas.append((path, t.dtype, tuple(t.shape), off, t.numel() * t.element_size()))
                off += -(-metas[-1][4] // _ALIGN) * _ALIGN
            if off > slot_bytes:  # oversized sample: the queue path
                q.put(("sample", _pack_inline(sample)))
                continue
            slot = free_q.get()  # blocks until the parent frees a slot
            base = slot * slot_bytes
            for (path, t), (_, _, _, o, n) in zip(tensors, metas):
                if n:
                    shm.buf[base + o : base + o + n] = _leaf_bytes(t).numpy()
            q.put(("shm", (widx, slot, metas, skel)))
    except BaseException as e:  # surface the traceback text in the parent
        import traceback

        q.put((_ERROR, (widx, f"{e!r}\n{traceback.format_exc()}")))
    finally:
        q.put((_DONE, widx))
        if shm is not None:
            shm.close()


def _shm_free_bytes() -> Optional[int]:
    try:
        st = os.statvfs("/dev/shm")
        return st.f_bavail * st.f_frsize
    except OSError:  # non-Linux / unusual mount: no check possible
        return None


class ParallelSampleSource:
    """Iterate a splittable dataset with ``num_workers`` decode processes.

    ``dataset`` must expose ``split(n) -> list[iterable]`` returning n
    disjoint sub-datasets (``RandomMix`` and ``_ZippedShardSet`` split by
    round-robin shard assignment). Re-iterable: every ``iter()`` starts a
    fresh worker set.

    ``ordered=True`` merges in strict round-robin order (deterministic for a
    fixed (num_workers, seed), but a slow worker stalls the stream);
    ``ordered=False`` yields samples as they complete from one shared queue
    (the same set of samples, in no fixed order). ``transport`` is "shm"
    (a ring of ``queue_depth`` slots of ``slot_bytes`` a worker) or "queue";
    a ring that ``/dev/shm`` cannot hold falls back to "queue" with a
    warning. ``transport_used`` says which ran in the last pass.
    """

    def __init__(
        self,
        dataset: Any,
        num_workers: int,
        queue_depth: int = 16,
        mp_context: str = "forkserver",
        ordered: bool = True,
        transport: str = "shm",
        slot_bytes: int = 8 << 20,
    ) -> None:
        if num_workers <= 0:
            raise ValueError("num_workers must be positive")
        if not hasattr(dataset, "split"):
            raise TypeError(
                f"{type(dataset).__name__} does not support worker splitting (needs .split(n)); use num_workers=0"
            )
        if transport not in ("queue", "shm"):
            raise ValueError(f"transport must be 'queue' or 'shm', got {transport!r}")
        self.dataset = dataset
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self.mp_context = mp_context
        self.ordered = ordered
        self.transport = transport
        self.slot_bytes = slot_bytes
        self.transport_used: Optional[str] = None

    def _rings(self, ctx: Any, n: int) -> tuple[list, list]:
        """One shared-memory ring and free-slot queue a worker, or Nones
        (with a warning) where ``/dev/shm`` cannot hold them."""
        from multiprocessing import shared_memory

        shms: list[Any] = [None] * n
        free_qs: list[Any] = [None] * n
        need = n * self.queue_depth * self.slot_bytes
        free = _shm_free_bytes()
        try:
            # tmpfs allocates lazily: SharedMemory(create=True) succeeds on an
            # undersized /dev/shm and the first ring write dies with SIGBUS in
            # a worker, so the size is checked up front
            if free is not None and need > free * 0.9:
                raise OSError(28, f"ring needs {need} bytes but /dev/shm has {free} free")
            for i in range(n):
                shms[i] = shared_memory.SharedMemory(create=True, size=self.queue_depth * self.slot_bytes)
                free_qs[i] = ctx.Queue()
                for s in range(self.queue_depth):
                    free_qs[i].put(s)
        except OSError as e:  # /dev/shm too small (tight containers)
            warnings.warn(f"shared-memory ring allocation failed ({e}); loader workers fall back to the "
                          "pickle/queue transport")
            for s in shms:
                if s is not None:
                    s.close()
                    s.unlink()
            return [None] * n, [None] * n
        return shms, free_qs

    def __iter__(self) -> Iterator[Any]:
        mp_context = self.mp_context
        mainf = getattr(sys.modules.get("__main__"), "__file__", None)
        if mp_context == "forkserver" and (mainf is None or not os.path.exists(mainf)):
            # forkserver/spawn children re-import __main__ from its path; a
            # stdin/REPL program has none, so its children would die in
            # bootstrap. Fork needs no re-import.
            mp_context = "fork"
        ctx = mp.get_context(mp_context)
        parts = self.dataset.split(self.num_workers)
        n = len(parts)
        if self.ordered:
            queues = [ctx.Queue(maxsize=self.queue_depth) for _ in parts]
        else:
            shared = ctx.Queue(maxsize=self.queue_depth * n)
            queues = [shared] * n
        if self.transport == "shm":
            shms, free_qs = self._rings(ctx, n)
        else:
            shms, free_qs = [None] * n, [None] * n
        self.transport_used = "shm" if shms[0] is not None else "queue"

        def materialize(widx: int, slot: int, metas: list, skel: Any) -> Any:
            base = slot * self.slot_bytes
            sample = skel
            for path, dtype, shape, off, nbytes in metas:
                if nbytes:
                    t = torch.frombuffer(shms[widx].buf, dtype=torch.uint8, count=nbytes, offset=base + off).clone()
                else:
                    t = torch.empty(0, dtype=torch.uint8)
                sample = _set_path(sample, path, t.view(dtype).reshape(shape))
            free_qs[widx].put(slot)  # reusable once every leaf is copied out
            return sample

        procs = [
            ctx.Process(
                target=_worker_main,
                args=(part, q, i, shms[i].name if shms[i] is not None else None, self.slot_bytes, free_qs[i]),
                daemon=True,
            )
            for i, (part, q) in enumerate(zip(parts, queues))
        ]

        def get_checked(q: Any, who: list[int]) -> tuple:
            """q.get that cannot hang on a dead worker: a worker of ``who``
            that exited (exit code 0 included) without its sentinel raises."""
            while True:
                try:
                    return q.get(timeout=WORKER_POLL_S)
                except _queue.Empty:
                    dead = [i for i in who if procs[i].exitcode is not None]
                    if dead:
                        try:  # grace: the queue's feeder may be flushing the sentinel just now
                            return q.get(timeout=1)
                        except _queue.Empty:
                            pass
                        raise RuntimeError(
                            f"loader worker(s) {dead} died (exit codes {[procs[i].exitcode for i in dead]}) "
                            "without reporting; if the dataset class is defined in a stdin/REPL __main__, the "
                            "forkserver context cannot reconstruct it in the child: run from a file or pass "
                            "mp_context='fork'"
                        )

        def sample_of(kind: str, payload: Any) -> Any:
            if kind == "sample":
                return _unpack_inline(payload)
            if kind == "shm":
                return materialize(*payload)
            widx, text = payload
            raise RuntimeError(f"loader worker {widx} failed:\n{text}")

        try:
            # inside the try: a Process.start() failure must still run the
            # finally (terminate started workers, unlink the rings)
            for p in procs:
                p.start()
            if self.ordered:
                live = list(range(n))
                while live:
                    next_live = []
                    for i in live:
                        kind, payload = get_checked(queues[i], [i])
                        if kind != _DONE:
                            yield sample_of(kind, payload)
                            next_live.append(i)
                    live = next_live
            else:
                running = set(range(n))
                while running:
                    kind, payload = get_checked(shared, sorted(running))
                    if kind == _DONE:
                        running.discard(payload)
                    else:
                        yield sample_of(kind, payload)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=5)
            for s in shms:
                if s is not None:
                    s.close()
                    try:
                        s.unlink()
                    except FileNotFoundError:
                        pass


def measure_loader_throughput(loader: Iterable[dict], max_batches: int = 16, warmup: int = 1) -> dict[str, float]:
    """Images/s and MB/s of a batched loader, over ``max_batches`` batches
    after ``warmup`` (the first includes the workers' start)."""

    def batch_bytes(b: Any) -> int:
        if isinstance(b, dict):
            return sum(batch_bytes(v) for v in b.values())
        if isinstance(b, torch.Tensor):
            return b.numel() * b.element_size()
        return len(pickle.dumps(b))

    it = iter(loader)
    for _ in range(warmup):
        next(it)
    images = nbytes = n = 0
    t0 = time.perf_counter()
    for batch in it:
        images += batch["image"].shape[0]
        nbytes += batch_bytes(batch)
        n += 1
        if n >= max_batches:
            break
    dt = time.perf_counter() - t0
    return {"batches": n, "images_per_sec": images / dt, "mb_per_sec": nbytes / dt / 1e6, "seconds": dt}
