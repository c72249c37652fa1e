"""A tiny configuration and a benchmark around it, for tests on the CPU:
DeiT-Tiny's widths cut to two layers, a 16² and a 64² teacher."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from perfbench import spec

TEACHERS = {"facebook/dinov2-large": [64, 16, 16], "facebook/sam-vit-huge": [16, 64, 64]}


def config() -> dict:
    cfg = spec.load_json(spec.PACKAGE / "configs" / "theia-base-cddsv.json")
    cfg.update(name="tiny", backbone="facebook/deit-tiny-patch16-224", hidden_size=192, num_attention_heads=3,
               intermediate_size=768, num_hidden_layers=2, teachers=copy.deepcopy(TEACHERS))
    return cfg


def bench(tmp: Path) -> dict:
    """BENCHMARK.json with every cell on the tiny configuration."""
    path = tmp / "tiny.json"
    path.write_text(json.dumps(config()))
    b = copy.deepcopy(spec.benchmark())
    b["configs"].append({"name": "tiny", "source": "test", "file": str(path), "reduced": [], "why": "test"})
    for w in b["workloads"]:
        w["config"] = "tiny"
    return b


def cell(name: str, batch: int = 4) -> dict:
    """The cell's file with a tiny batch (its limits kept)."""
    c = spec.load_json(spec.cell_file(name))
    c.update(batch=batch)
    return c
