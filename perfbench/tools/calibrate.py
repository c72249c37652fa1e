"""Readings that a cell's check limits are set from, many seeds in one process.

    python3 perfbench/tools/calibrate.py --workload <name> --seeds 1-12 [--control-seeds 3]
        [--seconds 3] [--out FILE]

For each seed it sets the cell up as a benchmark run does (the same
driver, weights, inputs and timed path at the cell's size), runs the
program's part of the check, frees the program and compares with the
float32 reference: the program's readings, whose largest over the seeds is
a number's lower reading. For the first ``--control-seeds`` seeds it also
reads the control in place of the program, the reference one precision
lower than the configuration states (fp8 for a bf16 recipe, TF32 for
float32 serving), and for a train cell the fault of half the batch left out
(the reference on the first half of each batch, the mean over it): their
smallest readings are the upper ones. A bf16 cell also reads the reference
with only its matrix products in fp8, for comparison. One JSON line a reading, then a
summary line. Needs a CUDA card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CONTROL = {"bfloat16": "fp8", "float32": "tf32"}


def seeds_of(text: str) -> list[int]:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi) + 1)) if hi else [int(lo)]
    return out


def readings(name: str, seed: int, control: bool, seconds: float, device) -> list[dict]:
    import torch

    from perfbench import check, spec

    bench = spec.benchmark()
    entry = spec.cell_entry(bench, name)
    cell = spec.load_json(spec.cell_file(name))
    cfg = spec.load_json(ROOT / spec.config_entry(bench, entry["config"])["file"])
    traffic = spec.load_json(spec.traffic_file(entry["traffic"]))
    drv = spec.driver_class(traffic["driver"])(cfg, traffic, cell, seed, device)
    out = []
    t0 = time.perf_counter()
    drv.setup()
    if traffic["driver"] == "train":
        drv.free()
        ref = drv.reference()
        out.append({"seed": seed, "side": "program", **check.train_numbers(drv.prog, ref)[0]})
        if control:
            precision = CONTROL[traffic["recipe"]["compute_dtype"]]
            out.append({"seed": seed, "side": f"control_{precision}",
                        **check.train_numbers(drv.reference(precision), ref)[0]})
            if precision == "fp8":  # what fp8 products alone read, beside the control
                out.append({"seed": seed, "side": "variant_fp8_gemm",
                            **check.train_numbers(drv.reference("fp8_gemm"), ref)[0]})
            half = drv.reference(batch_rows=drv.batch // 2)
            out.append({"seed": seed, "side": "fault_half_batch", **check.train_numbers(half, ref)[0]})
    else:
        drv.window(seconds)
        drv.free()
        ref = drv.reference()
        out.append({"seed": seed, "side": "program", **drv.numbers(ref)[0]})
        if control:
            precision = CONTROL[traffic["dtype"]]
            low = drv.reference(precision)
            gaps = [check.rel_l2(low[k], ref[k]) for k in ref]
            out.append({"seed": seed, "side": f"control_{precision}", "feature_rel_l2": max(gaps)})
    for r in out:
        r["seconds"] = time.perf_counter() - t0
    del drv
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="1-12")
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0, help="a serve cell's window, long enough to fill its sample")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    rows = []
    sink = open(args.out, "a") if args.out else None
    for i, seed in enumerate(seeds_of(args.seeds)):
        for r in readings(args.workload, seed, i < args.control_seeds, args.seconds, torch.device("cuda", 0)):
            r["workload"] = args.workload
            rows.append(r)
            line = json.dumps(r)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    summary = {"workload": args.workload, "device": torch.cuda.get_device_name(0)}
    for side in sorted({r["side"] for r in rows}):
        keys = [k for k in rows[0] if k not in ("seed", "side", "seconds", "workload")]
        picked = [r for r in rows if r["side"] == side]
        pick = max if side == "program" else min
        summary[side] = {k: pick(r[k] for r in picked if k in r) for k in keys if any(k in r for r in picked)}
        summary[side]["seeds"] = len(picked)
    print(json.dumps(summary), flush=True)
    if sink:
        sink.write(json.dumps(summary) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
