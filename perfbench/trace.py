"""Device traces: a short torch.profiler (CUPTI) capture read in memory.

``capture(fn)`` profiles one call of ``fn`` (a few train steps, some tens
of served batches) on the device alone and keeps every device kernel's
name and interval: the device metrics read these. The profiler's cost on
the host, one record an operator, would lengthen a host-paced step, so the
host's operators are left out here; CUPTI still costs the host a little a
launch, so the idle share is taken against the window's step
(``readers.idle_pct``), not the traced span. ``capture(fn, host=True)`` keeps them too, with the launch times of the
kernels, so that an idle gap on the device can be labelled by what the
host was doing when it ended; only the breakdown's gaps read such a
capture. No trace file is written.

``CLASSES`` and ``busy_ms`` are frozen copies of
``theia_tpu_torch/tools/profile_train_step.py``'s.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable

import torch

# kernel-name substrings -> class, first match wins
CLASSES = (
    ("K1 mha_fwd", ("mha_fwd",)),
    ("K2 mha_bwd", ("mha_bwd",)),
    ("K7 flash_fwd", ("flash_fwd",)),
    ("K9 flash_dq", ("flash_dq",)),
    ("K8 flash_dkv", ("flash_dkv",)),
    ("K3 ln_bwd_stats", ("ln_bwd_stats",)),
    ("K4 ln_bwd_dx", ("ln_bwd_dx",)),
    ("K5 loss_sums_fwd", ("loss_sums_partial", "loss_sums_finish")),
    ("K6 loss_sums_bwd", ("loss_sums_bwd",)),
    ("conv (cuDNN)", ("conv", "cudnn", "dgrad", "wgrad", "implicit", "xmma_fprop", "winograd")),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "sm90_xmma", "cutlass", "cublas", "Kernel2")),
    ("LayerNorm (encoder)", ("layer_norm", "LayerNorm", "GammaBeta")),
    ("reductions", ("reduce_kernel", "Reduce")),
    ("copies and casts", ("copy", "Memcpy", "Memset", "cat_", "CatArray")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "foreach")),
)


def kernel_class(name: str) -> str:
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other"


def busy_ms(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in the trace's us -> ms."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


@dataclass
class Kernel:
    name: str
    start_us: float
    dur_us: float
    correlation: int


@dataclass
class Trace:
    """What a capture keeps; times in microseconds on the trace's clock."""

    kernels: list[Kernel] = field(default_factory=list)
    host_ops: list[tuple[float, float, str, int]] = field(default_factory=list)  # (start, end, name, thread)
    launches: dict[int, tuple[float, int]] = field(default_factory=dict)  # correlation -> (launch time, thread)

    def window_us(self) -> float:
        """From the first kernel's start to the last kernel's end."""
        if not self.kernels:
            return 0.0
        return max(k.start_us + k.dur_us for k in self.kernels) - min(k.start_us for k in self.kernels)

    def busy_us(self) -> float:
        return 1e3 * busy_ms([(k.start_us, k.start_us + k.dur_us) for k in self.kernels])

    def class_us(self, label: str) -> float:
        return sum(k.dur_us for k in self.kernels if kernel_class(k.name) == label)

    def matching(self, *keys: str) -> list[Kernel]:
        return [k for k in self.kernels if any(s in k.name for s in keys)]

    def top_kernels(self, n: int = 10) -> list[list]:
        by = defaultdict(float)
        for k in self.kernels:
            by[k.name] += k.dur_us
        return [[name, us / 1e6] for name, us in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10, labelled: int = 2000) -> list[list]:
        """The device's idle time between kernels, summed by what the host
        was doing when a gap ended: the innermost host operator, on the
        launching thread, around the launch of the
        kernel that ended it. The ``labelled`` longest gaps are labelled;
        the rest are summed as "shorter gaps"."""
        ks = sorted(self.kernels, key=lambda k: k.start_us)
        gaps, end = [], None
        for k in ks:
            if end is not None and k.start_us > end:
                gaps.append((k.start_us - end, k))
            end = k.start_us + k.dur_us if end is None else max(end, k.start_us + k.dur_us)
        gaps.sort(key=lambda g: -g[0])
        threads: dict[int, list] = defaultdict(list)
        for op in self.host_ops:
            threads[op[3]].append(op)
        for ops in threads.values():
            ops.sort()
        starts = {tid: [o[0] for o in ops] for tid, ops in threads.items()}
        by = defaultdict(float)
        for us, k in gaps[:labelled]:
            by[self._host_label(k, threads, starts)] += us
        rest = sum(us for us, _ in gaps[labelled:])
        if rest:
            by["shorter gaps"] += rest
        return [[label, us / 1e6] for label, us in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_label(self, k: Kernel, threads, starts, scan: int = 64) -> str:
        launch = self.launches.get(k.correlation)
        if launch is None:
            return "unknown"
        t, tid = launch
        ops = threads.get(tid, [])
        i = bisect.bisect_right(starts.get(tid, []), t) - 1
        for j in range(i, max(i - scan, -1), -1):
            s, e, name, _ = ops[j]
            if e >= t:  # nested operators: the latest-starting one around t is the innermost
                return name
        return "none"


def capture(fn: Callable[[], None], host: bool = False) -> Trace:
    """Profile one call of ``fn`` on the CUDA device (and with ``host``, the
    host's operators) and read the events in memory."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        fn()
    out = Trace()
    device = []
    for e in prof.profiler.kineto_results.events():
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((e, name, start, dur))
        elif "LaunchKernel" in name or "cuLaunch" in name:
            out.launches[e.correlation_id()] = (start, e.start_thread_id())
        else:
            out.host_ops.append((start, start + dur, name, e.start_thread_id()))
    # a host range (record_function) that launched device work shows on the
    # device's timeline too, under its own name: it is no kernel
    host_names = {op[2] for op in out.host_ops}
    out.kernels = [Kernel(name, start, dur, e.correlation_id()) for e, name, start, dur in device
                   if name not in host_names and _is_kernel(e)]
    return out


def _is_kernel(e) -> bool:
    """A device event that is a kernel, not a copy or a fill (CUPTI names
    those "Memcpy ..." and "Memset ...")."""
    return not e.name().startswith(("Memcpy", "Memset"))
