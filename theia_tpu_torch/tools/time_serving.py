"""Time the eager serving path's B=1 latency of this tree against an earlier tree, on one GPU.

    python -m theia_tpu_torch.tools.time_serving --parent DIR [--calls 50]

Runs one child process a tree, in the order parent, this, this, parent (so
that a drift of the card or the host over the call shows as a spread,
not as a difference). Each child imports ``theia_tpu_torch`` from its own
tree, builds Theia-Base cddsv from seeded random weights (``build_theia``,
float32, then bf16 compute over bf16 storage), and times
``forward_feature`` on one uint8 224² image: 5 warmup calls, then
``--calls`` calls, each synchronous, with CUDA events around it (the host's
launches included). It prints each child's p50, min and max and K1's
launches a call, with the card's name and power limit. Each tree builds
its kernels once, in its first child. Exits nonzero without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, statistics, sys
import numpy as np
import torch
from theia_tpu_torch.models.hub import build_theia
from theia_tpu_torch.ops import attention

calls = int(sys.argv[1])
x1 = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (1, 224, 224, 3), dtype=np.uint8)).cuda()
out = {}
for name, kw in (("float32", {}), ("bf16", dict(dtype=torch.bfloat16, param_dtype=torch.bfloat16))):
    model = build_theia("theaiinstitute/theia-base-patch16-224-cddsv", generator=torch.Generator().manual_seed(0), **kw)
    with torch.inference_mode():
        for _ in range(5):
            model.forward_feature(x1)
        before = attention.MHA_FWD_LAUNCHES
        samples = []
        for _ in range(calls):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            model.forward_feature(x1)
            end.record()
            torch.cuda.synchronize()
            samples.append(start.elapsed_time(end))
    out[name] = dict(p50=statistics.median(samples), min=min(samples), max=max(samples),
                     k1_a_call=(attention.MHA_FWD_LAUNCHES - before) / calls)
    del model
print("RESULT " + json.dumps(out))
"""


def run(tree: Path, calls: int) -> dict:
    proc = subprocess.run([sys.executable, "-c", CHILD, str(calls)], cwd=tree, capture_output=True, text=True,
                          timeout=900)
    if proc.returncode:
        raise RuntimeError(f"child in {tree} failed:\n{proc.stderr[-4000:]}")
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT "))
    return json.loads(line.removeprefix("RESULT "))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path, required=True, help="an unpacked earlier tree")
    parser.add_argument("--calls", type=int, default=50)
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_serving: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    here = Path(__file__).resolve().parents[2]
    print(card)
    for label, tree in (("parent", args.parent), ("this", here), ("this", here), ("parent", args.parent)):
        res = run(tree.resolve(), args.calls)
        print(f"{label} ({tree}): " + "; ".join(
            f"{name} forward_feature B=1 p50 {r['p50']:.3f} ms (min {r['min']:.3f}, max {r['max']:.3f}; "
            f"K1 {r['k1_a_call']:.0f} a call)" for name, r in res.items()) + f" ({card})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
