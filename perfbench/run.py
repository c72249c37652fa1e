"""Run one benchmark cell once and print its result as one JSON line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads the cell, its configuration and its traffic mix by the names in
``BENCHMARK.json`` (``perfbench/spec.py`` says where each lives), takes the
host's intra-op threads from the traffic mix (``host_threads``), sets the
cell up from the seed (weights and inputs drawn on the card, the program
built, every shape warmed up; ``setup_s`` runs from the process's start to
here), measures for ``--seconds``, and then, with ``--trace 1``, profiles a
few more steps or batches twice: on the device alone for the per-layer
metrics, then with the host's operators to label the device's idle gaps
(``perfbench/trace.py``). Then it frees the program and holds what the
window produced against the plain reference (``perfbench/check.py``); each
number compared is printed beside its limit as the last lines of standard
error and under "check", the last key of the result. With ``--trace 0``
the metrics are the cell's end-to-end ones, with ``--trace 1`` its
per-layer ones.

Exits 2 without a result when no CUDA card (or fewer than the cell asks
for) is present, and 3 when JAX, flax or the JAX package were loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "theia_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _cache_env() -> None:
    """Kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "perfbench" / "_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(cache / "nv"))
    os.environ.setdefault("USE_FLAX", "0")


def run_cell(name: str, seed: int, seconds: float, traced: bool, device, t0: float, bench: dict | None = None,
             cell: dict | None = None) -> tuple[dict, list[str]]:
    """One run of cell ``name``: (the result's object, the lines for standard
    error, the check's last). ``bench`` and ``cell`` stand in for
    ``BENCHMARK.json`` and the cell's file."""
    import torch

    from perfbench import check, spec, trace
    from perfbench.readers import Readings

    bench = bench or spec.benchmark()
    entry = spec.cell_entry(bench, name)
    cell = cell if cell is not None else spec.load_json(spec.cell_file(name))
    cfg = spec.load_json(ROOT / spec.config_entry(bench, entry["config"])["file"])
    traffic = spec.load_json(spec.traffic_file(entry["traffic"]))
    drv = spec.driver_class(traffic["driver"])(cfg, traffic, cell, seed, device)
    cuda = device.type == "cuda"

    drv.setup()
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0
    window = drv.window(seconds)
    window["setup_s"] = setup_s
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    units = int(traffic["trace_units"])
    tr = gaps = None
    if traced:  # on the device alone for the metrics, then with the host's operators to label the gaps
        tr = trace.capture(lambda: drv.run_units(units))
        gaps = trace.capture(lambda: drv.run_units(units), host=True)
    drv.free()
    numbers, where = drv.compare()
    limits = cell.get("limits", {})
    correct = check.judge(numbers, limits) and window["failed"] == 0

    lines = []
    if traced:
        readings = Readings(cfg, traffic, cell, int(cell["batch"]), units, tr, window)
        metrics = {}
        for m in spec.per_layer_for(bench, name):
            value = spec.metric_reader(m["name"]).read(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": window[m["name"]], "unit": m["unit"]} for m in spec.end_to_end_for(bench, name)}
    device_info = {
        "platform": "gpu" if cuda else device.type,
        "kind": torch.cuda.get_device_name(device) if cuda else device.type,
        "count": int(entry["chips"]),
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": bool(correct), "attempted": int(window["attempted"]), "failed": int(window["failed"]),
              "metrics": metrics, "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_us() / 1e6
        device_info["window_s"] = tr.window_us() / 1e6
        result["breakdown"] = {"device_ops": tr.top_kernels(), "idle_gaps": gaps.idle_gaps()}
        lines.append(f"trace: {units} {drv.unit} took {tr.window_us() / 1e3 / units!r} ms each traced on the device "
                     f"alone, {gaps.window_us() / 1e3 / units!r} with the host's operators; the window's "
                     f"{window['done']} took {1e3 * window['seconds'] / max(window['done'], 1)!r}")
    result["check"] = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    lines += [f"check {k} {v!r} limit {limits[k]!r} (worst at {where.get(k, 'the run')})" if k in limits
              else f"check {k} {v!r} not compared (it separates no reading in this cell)" for k, v in numbers.items()]
    lines.append(f"check failed_{drv.unit} {window['failed']} limit 0")
    return result, lines


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from perfbench import spec

    bench = spec.benchmark()
    entry = spec.cell_entry(bench, args.workload)
    chips = int(entry["chips"])
    _cache_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    torch.set_num_threads(int(spec.load_json(spec.traffic_file(entry["traffic"]))["host_threads"]))
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                             _T0, bench)
    leaked = forbidden_modules()
    if leaked:
        print(f"perfbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    sys.stderr.write("\n".join(lines) + "\n")
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
