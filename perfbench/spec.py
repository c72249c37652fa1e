"""Where the benchmark's parts live, found by the names ``BENCHMARK.json`` gives them.

  - a cell:            perfbench/workloads/<name>.json (batch, check limits, ...)
  - a configuration:   the ``file`` its entry names (perfbench/configs/<name>.json)
  - a traffic mix:     perfbench/traffic/<name>.json (names its driver)
  - a driver:          perfbench/drivers/<driver>.py, its class ``Driver``
  - a per-layer metric: perfbench/metrics/<name>.py, a ``read(readings)``

Adding any of them adds files and entries; no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def cell_file(name: str) -> Path:
    return PACKAGE / "workloads" / f"{name}.json"


def traffic_file(name: str) -> Path:
    return PACKAGE / "traffic" / f"{name}.json"


def metric_file(name: str) -> Path:
    return PACKAGE / "metrics" / f"{name}.py"


def driver_class(kind: str):
    if not kind.isidentifier():
        raise ValueError(f"no driver {kind!r}")
    return importlib.import_module(f"perfbench.drivers.{kind}").Driver


def metric_reader(name: str) -> ModuleType:
    """The metric's module, loaded from its file (a name may hold dots)."""
    path = metric_file(name)
    spec = importlib.util.spec_from_file_location("perfbench.metrics." + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def end_to_end_for(bench: dict, cell: str) -> list[dict]:
    """The end-to-end metrics the cell reports: those listing it, and those listing no cells."""
    return [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]


def per_layer_for(bench: dict, cell: str) -> list[dict]:
    """The per-layer metrics read in the cell: those listing it, or, without
    a list, every cell that reports the end-to-end metric it moves."""
    reported = {m["name"] for m in end_to_end_for(bench, cell)}
    out = []
    for m in bench["per_layer"]:
        cells = m.get("workloads")
        if (cell in cells) if cells is not None else (m["moves"] in reported):
            out.append(m)
    return out
