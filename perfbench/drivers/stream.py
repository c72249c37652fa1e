"""The "stream" driver: batches of images through ``serving.Predictor.predict_stream``.

Set-up draws the parameters on the device from the seed, builds the
program's model as ``from_pretrained`` serves it (the traffic's dtype, its
plain preprocessing and exact attention), wraps it in a ``Predictor`` at
the traffic's buckets and depth, makes a ring of distinct uint8 host
batches, and streams a few through to warm every shape.

The window is a closed loop: it hands the next ring batch to
``predict_stream`` as soon as the stream asks for one, so ``depth`` + 1
batches are always in flight and the load is fixed by the cell. A batch's
latency runs from the moment it is handed over until its result is a host
array. A seeded sample of the window's results (reservoir sampling, plus
the last batch) is kept for the check.
"""

from __future__ import annotations

import gc
import random
import time

import numpy as np
import torch

from perfbench import check, inputs, port
from perfbench.reference import model as ref

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Driver:
    unit = "batches"

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int, device: torch.device) -> None:
        self.cfg, self.traffic, self.cell, self.seed, self.device = cfg, traffic, cell, seed, device
        self.batch = int(cell["batch"])

    def setup(self) -> None:
        from theia_tpu_torch.models.hub import PretrainedTheia
        from theia_tpu_torch.serving import Predictor

        t = self.traffic
        gen = inputs.generator(self.seed, self.device)
        self.params0 = ref.make_params(self.cfg, gen, dtype=DTYPES[t["dtype"]])
        model = port.build(self.cfg, self.params0, dtype=DTYPES[t["dtype"]]).eval()
        self.model = PretrainedTheia(model).eval()
        self.predictor = Predictor(self.model, buckets=tuple(t["buckets"]), method=t["method"], depth=int(t["depth"]))
        self.ring = [inputs.images(self.batch, self.cfg, gen).cpu().numpy() for _ in range(int(t["ring"]))]
        for _ in self.predictor.predict_stream(self.ring[i % len(self.ring)] for i in range(int(t["warmup_batches"]))):
            pass
        sync(self.device)

    def _run(self, seconds: float, keep: int = 0) -> dict:
        """Stream until ``seconds`` have passed; returns the latencies and the kept results."""
        handed: list[float] = []
        t0 = time.perf_counter()
        deadline = t0 + seconds

        def feed():
            i = 0
            while (now := time.perf_counter()) < deadline:
                handed.append(now)
                yield self.ring[i % len(self.ring)]
                i += 1

        rng = random.Random(self.seed)
        slots: list[tuple[int, np.ndarray]] = []
        latencies = []
        last = None
        for k, out in enumerate(self.predictor.predict_stream(feed())):
            latencies.append(time.perf_counter() - handed[k])
            last = (k, out)
            if keep:  # reservoir sampling of ``keep`` results
                if len(slots) < keep:
                    slots.append(last)
                else:
                    j = rng.randrange(k + 1)
                    if j < keep:
                        slots[j] = last
        elapsed = time.perf_counter() - t0
        kept = dict(slots)
        if last is not None:
            kept[last[0]] = last[1]
        return {"latencies": latencies, "handed": len(handed), "kept": kept, "seconds": elapsed}

    def window(self, seconds: float) -> dict:
        sync(self.device)
        run = self._run(seconds, keep=int(self.traffic["check_batches"]))
        self.kept = run["kept"]
        lat_ms = [1e3 * x for x in run["latencies"]]
        n = len(lat_ms)
        out = {"attempted": run["handed"], "failed": run["handed"] - n, "done": n, "seconds": run["seconds"],
               "latencies_ms": lat_ms, "serve_images_per_s": n * self.batch / run["seconds"]}
        if n:
            out["serve_p95_ms"] = float(np.percentile(lat_ms, 95))
            out["serve_p50_ms"] = float(np.percentile(lat_ms, 50))
        return out

    def run_units(self, units: int) -> None:
        """``units`` more batches through a stream of their own, then a
        synchronize (for a trace)."""
        for _ in self.predictor.predict_stream(self.ring[i % len(self.ring)] for i in range(units)):
            pass
        sync(self.device)

    def free(self) -> None:
        self.predictor = self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict[int, torch.Tensor]:
        """The reference's features for each kept batch, on the device, in
        blocks of ``ref.block_rows`` images."""
        params = {k: v.float() for k, v in self.params0.items()}
        rows = ref.block_rows(self.cfg)
        out = {}
        with torch.no_grad(), ref.precision_flags(precision):
            for k in sorted(self.kept):
                images = torch.from_numpy(self.ring[k % len(self.ring)]).to(self.device)
                out[k] = torch.cat([ref.forward_feature(params, images[s:s + rows], self.cfg, precision)
                                    for s in range(0, images.shape[0], rows)])
        return out

    def numbers(self, reference: dict[int, torch.Tensor]) -> tuple[dict[str, float], dict[str, str]]:
        gaps = {k: check.rel_l2(torch.from_numpy(self.kept[k]).to(v.device), v) for k, v in reference.items()}
        worst = max(gaps, key=gaps.get)
        return {"feature_rel_l2": gaps[worst]}, {"feature_rel_l2": f"batch {worst} of the window"}

    def compare(self) -> tuple[dict[str, float], dict[str, str]]:
        return self.numbers(self.reference())
