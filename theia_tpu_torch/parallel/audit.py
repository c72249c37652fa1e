"""Collective audit: every collective the port issues, with its kind, payload
bytes and group size (port of theia_tpu/parallel/audit.py).

The JAX package reads its collectives out of the compiled program, since
the SPMD partitioner inserts them. The port has no compiled program to
read: each collective is a call made by hand, and every one goes through
the helpers of ``parallel/distributed.py`` (``all_reduce``, ``all_gather``,
``broadcast``, ``broadcast_object``), which call :func:`record`. While an
:func:`audit` is open, ``record`` appends ``{kind, bytes, group_size}``;
otherwise it does nothing. ``summarize`` groups the records as the JAX
``summarize`` does, under ``"<kind>@g<group size>"`` with ``count`` and
``bytes``, so the data group's gradient all-reduce separates from the
model group's tensor-parallel ones.

Kinds are the JAX audit's HLO names: "all-reduce", "all-gather",
"collective-broadcast". ``bytes`` is the result's payload (an all-gather's
whole gathered tensor), as the JAX audit counts a result shape; a pickled
object's broadcast records 0, its size being known on the source rank only.
"""

from __future__ import annotations

import contextlib
from typing import Any, Iterator, Optional

_RECORDS: Optional[list[dict[str, Any]]] = None


def record(kind: str, nbytes: int, group_size: int) -> None:
    """Note one collective while an audit is open; nothing otherwise."""
    if _RECORDS is not None:
        _RECORDS.append({"kind": kind, "bytes": int(nbytes), "group_size": int(group_size)})


@contextlib.contextmanager
def audit() -> Iterator[list[dict[str, Any]]]:
    """Collect the records of every collective issued inside the block into
    the yielded list. Audits do not nest."""
    global _RECORDS
    if _RECORDS is not None:
        raise RuntimeError("an audit is already open")
    _RECORDS = records = []
    try:
        yield records
    finally:
        _RECORDS = None


def summarize(stats: list[dict[str, Any]]) -> dict[str, dict[str, int]]:
    """Group records by 'kind@g<group_size>' -> {count, bytes}."""
    agg: dict[str, dict[str, int]] = {}
    for r in stats:
        key = f"{r['kind']}@g{r['group_size']}"
        slot = agg.setdefault(key, {"count": 0, "bytes": 0})
        slot["count"] += 1
        slot["bytes"] += r["bytes"]
    return dict(sorted(agg.items()))
