"""Device timing, ptxas's report, the library attention calls and the
parallel build of other versions of a kernel's source, shared by
``chip_smoke.py`` and the timing tools. Needs a CUDA device to time."""

from __future__ import annotations

import ctypes
import re
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

from theia_tpu_torch.kernels import build

# torch.cuda._sleep's unit is an SM clock cycle; at most 1.98 GHz on an H100
SLEEP_CYCLES_PER_MS = 2_000_000


def cuda_ms(fn, iters: int, hold: bool = False) -> float:
    """Mean device milliseconds per call over ``iters`` back-to-back calls.

    ``hold``: the stream first sleeps for twice the host's time to enqueue
    the calls (measured on one call, at least ~50 ms), so that the host
    enqueues them while the device waits and the events time the device's
    work alone, without the gaps of a host slower than the kernels. The
    calls must stay within the launch queue's depth (~1000 kernels)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda._sleep(int(max(50.0, 2 * iters * host_ms) * SLEEP_CYCLES_PER_MS))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def interleaved_ms(fns: dict, iters: int = 20, hold: bool = True) -> dict:
    """Each function's ms, timed in the order a, b, ..., ..., b, a after
    warmup; device time with the stream held (``cuda_ms``) unless ``hold``
    is False, which times back-to-back calls as the host issues them."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(cuda_ms(fns[k], iters, hold))
    return {k: sum(v) / len(v) for k, v in times.items()}


def _device_events(fn, iters: int) -> list:
    """torch.profiler's device events (kernels, memsets, copies) over
    ``iters`` calls of ``fn`` after one warm call, summed by name.

    The recorded calls follow a profiler warmup step of ``iters`` calls:
    CUPTI can miss a kernel launched just after tracing is switched on,
    which would count a call as less than its launches."""
    fn()
    torch.cuda.synchronize()
    schedule = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA], schedule=schedule) as prof:
        for _ in range(2):
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return [ev for ev in prof.key_averages() if ev.device_time_total > 0]


def kernel_ms(fn, iters: int = 50) -> dict[str, float]:
    """Device milliseconds per call of each CUDA kernel ``fn`` launches, by
    the kernel's name without its arguments (torch.profiler over ``iters``
    calls after one warm call)."""
    out = {}
    for ev in _device_events(fn, iters):
        name = profiled_kernel_name(ev.key)
        out[name] = out.get(name, 0.0) + ev.device_time_total / iters / 1e3
    return out


def device_ops(fn, iters: int = 10, sessions: int = 3) -> dict[str, float]:
    """Device operations (kernels, memsets, copies) per call of ``fn``, by
    name without arguments (torch.profiler over ``iters`` calls after one
    warm call), the largest count of each name over ``sessions`` profiler
    sessions: CUPTI can drop a record even after the warmup step (2 of 10
    launches once), never adds one, so one session can count a call as
    less than its launches."""
    out: dict[str, float] = {}
    for _ in range(sessions):
        seen: dict[str, float] = {}
        for ev in _device_events(fn, iters):
            name = profiled_kernel_name(ev.key)
            seen[name] = seen.get(name, 0.0) + ev.count / iters
        for name, n in seen.items():
            out[name] = max(out.get(name, 0.0), n)
    return out


def profiled_kernel_name(key: str) -> str:
    """A kernel's name without return type, namespace or arguments, from
    the profiler's ``void (anonymous namespace)::k<64, 2>(float*, ...)``."""
    return key.removeprefix("void ").removeprefix("(anonymous namespace)::").split("(")[0].strip()


def kernel_name(mangled: str) -> str:
    """A kernel's name as the tools print it (``mha_bwd_rows_bf16<64,2>``) from its mangled one."""
    m = re.search(r"\d(mha_\w+?|flash_\w+?|ln_bwd_\w+?)(?:ILi(\d+)E(?:Li(\d+)E)?|If?E|I13__nv_bfloat16E|E)",
                  mangled)
    loss = re.search(r"\d(loss_sums_[a-z]+)(?:I(\w+?)Lb([01])E)?", mangled)
    name = m.group(1) if m else mangled
    if loss:
        name = loss.group(1)
        if loss.group(2):
            # float is "f"; bf16 is "13__nv_bfloat16", or "S<n>_" where it repeats
            types = ",".join("f32" if x == "f" else "bf16"
                             for x in re.findall(r"f|13__nv_bfloat16|S\d*_", loss.group(2)))
            name += f"<{types},{'vec8' if loss.group(3) == '1' else 'scalar'}>"
    elif m and m.group(2):
        name += f"<{m.group(2)}{f',{m.group(3)}' if m.group(3) else ''}>"
    elif m and "ln_bwd" in name and "finish" not in name:
        name += "<bf16>" if "bfloat16" in mangled else "<f32>"
    return name


def ptxas_usage(log: str) -> list[tuple[str, str]]:
    """(kernel, "N registers, spills ...") for each kernel in nvcc's -Xptxas=-v output."""
    out, name, spills = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = kernel_name(line.split("'")[1])
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((name, f"{line.split('Used', 1)[1].strip()}; {spills}"))
    return out


def build_libraries(sources: dict[str, tuple[Path, tuple[str, ...], dict[str, list]]], work: Path,
                    report: Callable[[str, str], None]) -> dict[str, ctypes.CDLL]:
    """One shared library in ``work`` per name -> (source, -D settings, C
    functions -> their argtypes, each returning int), nvcc processes in
    parallel; ``report(name, log)`` reads each build's nvcc output."""
    procs = {}
    for name, (source, defines, _) in sources.items():
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o",
             str(work / f"lib{name}.so"), str(source)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-4000:]}")
        report(name, log)
        lib = ctypes.CDLL(str(work / f"lib{name}.so"))
        for fn, argtypes in sources[name][2].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def wgmma_serialized(log: str) -> list[tuple[str, str]]:
    """(kernel, ptxas's code and reason) for each kernel whose wgmma ptxas
    serialized (a performance loss ptxas reports as info, C75xx)."""
    out = []
    for line in log.splitlines():
        m = re.search(r"\((C75\d\d)\) Potential Performance Loss: wgmma\.mma_async instructions are serialized "
                      r"due to (.*?) (?:in|for) the function '(\w+)'", line)
        if m:
            out.append((kernel_name(m.group(3)), f"{m.group(1)}, {m.group(2)}"))
    return out


def sdpa_forward(q, k, v):
    """One PyTorch call for attention over [B, T, H, hd], as a function of no
    arguments: SDPA on the heads-first views (its flash kernel in bf16, its
    memory-efficient one in float32)."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return lambda: torch.nn.functional.scaled_dot_product_attention(qt, kt, vt)


def sdpa_backward(q, k, v, do):
    """One PyTorch call for dQ, dK, dV of attention over [B, T, H, hd], as a
    function of no arguments: SDPA's flash backward (bf16) or its
    memory-efficient backward (float32, which flash does not take), fed from
    the matching SDPA forward's output and log-sum-exp."""
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    if q.dtype == torch.bfloat16:
        out, lse, cq, ck, mq, mk, seed, offset, _ = torch.ops.aten._scaled_dot_product_flash_attention(qt, kt, vt)
        dout = torch.empty_like(out).copy_(do.transpose(1, 2))
        return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
            dout, qt, kt, vt, out, lse, cq, ck, mq, mk, 0.0, False, seed, offset)
    out, lse, seed, offset = torch.ops.aten._scaled_dot_product_efficient_attention(qt, kt, vt, None, True)
    dout = torch.empty_like(out).copy_(do.transpose(1, 2))
    return lambda: torch.ops.aten._scaled_dot_product_efficient_attention_backward(
        dout, qt, kt, vt, None, out, lse, seed, offset, 0.0, [True, True, True, False])
