"""Checkpoints with preemption-safe resume (port of theia_tpu/train/checkpoint.py).

The JAX package saves with orbax; the port writes one ``torch.save`` file a
step, ``<ckpt_dir>/<step>.pt``, with orbax's guarantees:

  - **atomic publication**: a step is written to a temporary name in the
    same directory and committed by ``os.replace``, so a kill mid-write can
    never corrupt the latest checkpoint — ``latest_step`` only ever sees
    committed steps, and a temporary left by a killed write is ignored;
  - **async saves**: ``CheckpointSession.save`` copies the state to host
    memory and waits for that copy before it returns (the train step
    updates parameters and moments in place, so the copy must be whole
    before the next step runs); only the file write runs in the background,
    and at most one is in flight: the next save first waits for it;
  - **robust restore**: ``restore_checkpoint`` tries committed steps
    newest-first and falls back, with a warning, if one is unreadable; if
    every step fails it raises the newest step's error;
  - the newest ``max_to_keep`` (5) steps are kept.

``read_params`` reads a step's parameters alone, for serving
(``models/pretrained.py``).

A file holds ``step``, ``params``, ``sched_count``, ``count``, ``mu`` and
``nu`` as CPU tensors in their own dtypes (bf16 moments stay bf16) and is
read with ``torch.load(weights_only=True)``. A restore copies into the
target state's tensors in place: ``TrainState.params`` are the model's own
parameters, and rebinding them would leave the model on its old weights.
"""

from __future__ import annotations

import os
import re
import threading
import time
import warnings
from typing import Any, Optional

import torch

from theia_tpu_torch.train.state import TrainState

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"{step}.pt")


def all_steps(ckpt_dir: str) -> list[int]:
    """Committed steps, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match, os.listdir(ckpt_dir)) if m)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def _flat(state: TrainState) -> dict[str, Any]:
    opt = state.opt_state
    return {"step": state.step, "params": state.params, "sched_count": opt.sched_count,
            "count": opt.count, "mu": opt.mu, "nu": opt.nu}


def _to_host(tree: dict[str, Any]) -> dict[str, Any]:
    """Copy every tensor of ``tree`` to host memory and wait for the copies.
    Device tensors go to page-locked memory with asynchronous copies, then
    one wait on each device's current stream."""
    devices: set[torch.device] = set()

    def copy(t: torch.Tensor) -> torch.Tensor:
        t = t.detach()
        if t.device.type == "cpu":
            return t.clone()
        devices.add(t.device)
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        return out.copy_(t, non_blocking=True)

    host = {k: {n: copy(t) for n, t in v.items()} if isinstance(v, dict) else copy(v) for k, v in tree.items()}
    for d in devices:
        torch.cuda.current_stream(d).synchronize()
    return host


def _write(ckpt_dir: str, host: dict[str, Any], step: int, max_to_keep: int) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = _step_path(ckpt_dir, step)
    tmp = f"{final}.tmp-{os.getpid()}-{threading.get_ident()}"
    with open(tmp, "wb") as f:
        torch.save(host, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)
    for old in all_steps(ckpt_dir)[:-max_to_keep]:
        os.remove(_step_path(ckpt_dir, old))


class CheckpointSession:
    """Checkpoints of one training run, with at most one write in flight.

    ``save`` returns once the state is in host memory; the file is written
    on a background thread while the card trains on. Call ``close`` (or use
    as a context manager) to wait for the last write. ``timings`` lists
    ``[step, seconds save() blocked, seconds the write took]`` per save (the
    write's time is filled in when it ends; a blocking save's blocked time
    includes its write)."""

    def __init__(self, ckpt_dir: str, max_to_keep: int = 5) -> None:
        self.ckpt_dir = ckpt_dir
        self.max_to_keep = max_to_keep
        self.timings: list[list] = []
        self._thread: Optional[threading.Thread] = None
        self._err: Optional[BaseException] = None

    def wait(self) -> None:
        """Wait for the write in flight; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, state: TrainState, step: int, block: bool = False) -> None:
        t0 = time.perf_counter()
        self.wait()
        host = _to_host(_flat(state))
        record = [step, None, None]
        self.timings.append(record)

        def write() -> None:
            t1 = time.perf_counter()
            try:
                _write(self.ckpt_dir, host, step, self.max_to_keep)
            except BaseException as e:
                self._err = e
            record[2] = time.perf_counter() - t1

        self._thread = threading.Thread(target=write, name=f"checkpoint-{step}", daemon=False)
        self._thread.start()
        if block:
            self.wait()
        record[1] = time.perf_counter() - t0

    def latest_step(self) -> Optional[int]:
        return latest_step(self.ckpt_dir)

    def close(self) -> None:
        self.wait()

    def __enter__(self) -> "CheckpointSession":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()


def save_checkpoint(ckpt_dir: str, state: TrainState, step: int, max_to_keep: int = 5) -> None:
    """One-shot blocking save (scripts and tests; the train loop uses
    ``CheckpointSession`` for async saves)."""
    _write(ckpt_dir, _to_host(_flat(state)), step, max_to_keep)


def _load_into(path: str, target: TrainState) -> None:
    """Read ``path`` and copy it into ``target``'s tensors; nothing is
    copied unless every name, shape and dtype matches."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    live = _flat(target)
    if set(saved) != set(live):
        raise ValueError(f"{path}: entries {sorted(saved)}, expected {sorted(live)}")
    pairs = []
    for k, v in live.items():
        if isinstance(v, dict):
            if set(saved[k]) != set(v):
                raise ValueError(f"{path}: {k} names differ from the target's ({len(saved[k])} vs {len(v)})")
            pairs += [(f"{k}.{n}", saved[k][n], t) for n, t in v.items()]
        else:
            pairs.append((k, saved[k], v))
    for name, src, dst in pairs:
        if src.shape != dst.shape or src.dtype != dst.dtype:
            raise ValueError(f"{path}: {name} is {src.dtype}{list(src.shape)}, "
                             f"the target's {dst.dtype}{list(dst.shape)}")
    with torch.no_grad():
        for _, src, dst in pairs:
            dst.copy_(src)


def _newest_readable(ckpt_dir: str, load) -> Optional[tuple[int, Any]]:
    """``(step, load(path))`` of the newest committed step that ``load``
    reads; None if the directory holds none. An unreadable step warns and
    falls back to the previous one; if every step fails, the newest step's
    error is raised."""
    first_err: Optional[Exception] = None
    for s in reversed(all_steps(ckpt_dir)):
        try:
            return s, load(_step_path(ckpt_dir, s))
        except Exception as e:
            first_err = first_err or e
            warnings.warn(f"checkpoint step {s} in {ckpt_dir} unreadable ({e!r}); trying an older step")
    if first_err is not None:
        raise first_err
    return None


def restore_checkpoint(ckpt_dir: str, target_state: TrainState, step: Optional[int] = None) -> Optional[TrainState]:
    """Restore into ``target_state`` in place and return it; None if the
    directory holds no committed step.

    With ``step=None``, committed steps are tried newest-first: if the
    newest is unreadable (a truncated or corrupt file), restore warns and
    falls back to the previous one; if every step fails — a mismatch of
    structure rather than corruption — the newest step's error is raised."""
    if step is not None:
        _load_into(_step_path(ckpt_dir, step), target_state)
        return target_state
    if _newest_readable(ckpt_dir, lambda path: _load_into(path, target_state)) is None:
        return None
    return target_state


def _params_of(path: str) -> dict[str, torch.Tensor]:
    saved = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(saved, dict) or not isinstance(saved.get("params"), dict):
        raise ValueError(f"{path} holds no train state (no 'params' entry)")
    return saved["params"]


def read_params(ckpt_dir: str, step: Optional[int] = None) -> tuple[int, dict[str, torch.Tensor]]:
    """The ``params`` of a committed step as CPU tensors, with the step,
    without building a ``TrainState`` (for serving a trained model). With
    ``step=None``: the newest readable step, with ``restore_checkpoint``'s
    fallback; raises ``FileNotFoundError`` if the directory holds none."""
    if step is not None:
        return step, _params_of(_step_path(ckpt_dir, step))
    found = _newest_readable(ckpt_dir, _params_of)
    if found is None:
        raise FileNotFoundError(f"no committed checkpoint step under {ckpt_dir}")
    return found
