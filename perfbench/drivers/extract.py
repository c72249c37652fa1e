"""The "extract" driver: teacher feature extraction as ``scripts/feature_extraction.py`` runs it.

Set-up draws the encoder's parameters on the device from the seed in HF's
state-dict layout (``perfbench/reference/sam.py``), builds the program's
teacher on them (``foundation/sam.py`` ``get_sam_model``, loaded
``strict=True``) and makes a ring of distinct uint8 host batches of the
configuration's input size, then runs a few batches through to warm every
shape.

The window is a closed loop with one batch in flight, as ``extract_shard``
runs: each ring batch goes through ``foundation/extraction.py``
``extract_batch``, which returns once both stores are bf16 host tensors, and
the next starts. Decoding the shards and writing the tar files are left out:
the disk is not the card's. A seeded sample of the window's batches
(reservoir sampling, plus the last) is kept for the check, each as the bf16
embedding the path returned and the float32 one it cast (the feature
function's output, held on the device).
"""

from __future__ import annotations

import gc
import random
import time

import torch

from perfbench import check, inputs
from perfbench.reference import sam as ref


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: dict, params: dict[str, torch.Tensor]) -> torch.nn.Module:
    """The program's SAM encoder on ``params``' device, loaded ``strict=True``."""
    from theia_tpu_torch.foundation.sam import SamVisionConfig, get_sam_model

    scfg = SamVisionConfig(
        hidden_size=cfg["hidden_size"], num_layers=cfg["num_hidden_layers"], num_heads=cfg["num_attention_heads"],
        mlp_dim=cfg["mlp_dim"], image_size=cfg["image_size"], patch_size=cfg["patch_size"],
        window_size=cfg["window_size"], global_attn_indexes=tuple(cfg["global_attn_indexes"]),
        output_channels=cfg["output_channels"], layer_norm_eps=cfg["layer_norm_eps"])
    device = next(iter(params.values())).device
    return get_sam_model(cfg["model"], state_dict=params, device=device, cfg=scfg)


class Driver:
    unit = "batches"

    def __init__(self, cfg: dict, traffic: dict, cell: dict, seed: int, device: torch.device) -> None:
        self.cfg, self.traffic, self.cell, self.seed, self.device = cfg, traffic, cell, seed, device
        self.batch = int(cell["batch"])
        self.count = 0  # batches run, the spans' unit

    def setup(self) -> None:
        from theia_tpu_torch.foundation.extraction import extract_batch
        from theia_tpu_torch.foundation.sam import get_sam_feature

        self.extract_batch, self.feature_fn = extract_batch, get_sam_feature
        gen = inputs.generator(self.seed, self.device)
        self.params0 = ref.make_params(self.cfg, gen)
        self.module = build(self.cfg, self.params0)
        s = self.cfg["input_size"]
        self.ring = [torch.randint(0, 256, (self.batch, s, s, 3), generator=gen, device=self.device,
                                   dtype=torch.uint8).cpu() for _ in range(int(self.traffic["ring"]))]
        self.run_units(int(self.traffic["warmup_batches"]))

    def _features(self, module, images):
        """The teacher's feature function, keeping its float32 output (on the device) of the batch."""
        out = self.feature_fn(module, images)
        self.last_f32 = out[0]
        return out

    def _batch(self, i: int) -> list[dict[str, torch.Tensor]]:
        """Ring batch ``i`` through ``extract_batch``."""
        self.count += 1
        return self.extract_batch(self.cfg["model"], self.module, self.ring[i % len(self.ring)], self._features,
                                  unit=self.count)

    def window(self, seconds: float) -> dict:
        sync(self.device)
        keep = int(self.traffic["check_batches"])
        rng = random.Random(self.seed)
        slots: list[tuple[int, tuple]] = []
        last = None
        done = 0
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while time.perf_counter() < deadline:
            samples = self._batch(done)
            last = (done, (samples, self.last_f32))
            if len(slots) < keep:  # reservoir sampling of ``keep`` batches
                slots.append(last)
            else:
                j = rng.randrange(done + 1)
                if j < keep:
                    slots[j] = last
            done += 1
        elapsed = time.perf_counter() - t0
        self.last_f32 = None
        kept = dict(slots)
        if last is not None:
            kept[last[0]] = last[1]
        self.kept = {k: (torch.stack([s["embedding"] for s in samples]), f32) for k, (samples, f32) in kept.items()}
        return {"attempted": done, "failed": 0, "done": done, "seconds": elapsed,
                "serve_images_per_s": done * self.batch / elapsed}

    def run_units(self, units: int) -> None:
        """``units`` more batches (for a trace), then a synchronize."""
        for i in range(units):
            self._batch(i)
        self.last_f32 = None
        sync(self.device)

    def free(self) -> None:
        self.module = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32") -> dict[int, torch.Tensor]:
        """The reference's float32 embedding [B, 256, 64, 64] of each kept batch, on the device."""
        out = {}
        with torch.no_grad():
            for k in sorted(self.kept):
                images = self.ring[k % len(self.ring)].to(self.device)
                out[k] = ref.features(self.params0, images, self.cfg, precision)[0]
        return out

    def numbers(self, reference: dict[int, torch.Tensor]) -> tuple[dict[str, float], dict[str, str]]:
        """``feature_rel_l2``: the worst kept batch's distance of the bf16
        embedding the path returned from the reference rounded to bf16 the
        same way; ``feature_rel_l2_f32``: of the float32 embedding before the
        cast from the reference."""
        served = {k: check.rel_l2(self.kept[k][0].to(v.device), v.to(torch.bfloat16)) for k, v in reference.items()}
        f32 = {k: check.rel_l2(self.kept[k][1], v) for k, v in reference.items()}
        worst, worst_f32 = max(served, key=served.get), max(f32, key=f32.get)
        return ({"feature_rel_l2": served[worst], "feature_rel_l2_f32": f32[worst_f32]},
                {"feature_rel_l2": f"batch {worst} of the window",
                 "feature_rel_l2_f32": f"batch {worst_f32} of the window"})

    def compare(self) -> tuple[dict[str, float], dict[str, str]]:
        return self.numbers(self.reference())
