"""``BENCHMARK.json`` and the files it names: every part resolves to its file,
names and units keep to their characters, every per-layer metric's cells
report the end-to-end metric it moves, and no module of the benchmark
imports JAX or the JAX package (nor the reference the program)."""

from __future__ import annotations

import ast
import re
from pathlib import Path

import pytest

from perfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
PATH = re.compile(r"[A-Za-z0-9_.\-/]{1,200}")
FORBIDDEN = {"jax", "jaxlib", "flax", "theia_tpu"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def _imports(path: Path) -> set[str]:
    """Top-level names of every module a source file imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and all(PATH.fullmatch(p) and not p.startswith("/") for p in BENCH["paths"])
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w for w in BENCH["command"])
    assert (spec.ROOT / BENCH["command"][1]).resolve().is_relative_to(spec.PACKAGE)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_texts():
    groups = [BENCH["configs"], BENCH["workloads"], BENCH["end_to_end"], BENCH["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.fullmatch(n) for n in names)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"] and "\t" not in e["why"]
    for m in BENCH["per_layer"]:
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
    for w in BENCH["workloads"]:
        assert NAME.fullmatch(w["traffic"]) and NAME.fullmatch(w["config"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_part_resolves_to_its_file():
    for c in BENCH["configs"]:
        path = spec.ROOT / c["file"]
        assert path.is_file() and path.resolve().is_relative_to(spec.PACKAGE)
        cfg = spec.load_json(path)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"] and cfg["reduced"] == c["reduced"]
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert spec.cell_file(w["name"]).is_file()
        traffic = spec.load_json(spec.traffic_file(w["traffic"]))
        assert spec.driver_class(traffic["driver"])
    for m in BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_every_cell_reports_what_it_must():
    for cell in CELLS:
        e2e = {m["name"] for m in spec.end_to_end_for(BENCH, cell)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.per_layer_for(BENCH, cell)
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in spec.end_to_end_for(BENCH, cell)}


def _perf_md_layers() -> set[str]:
    """The first cell of each row of PERF.md's table of layers (section 3)."""
    text = (spec.ROOT / "PERF.md").read_text()
    section = text.split("\n## 3.", 1)[1].split("\n## ", 1)[0]
    rows = [line.split("|")[1].strip() for line in section.splitlines() if line.startswith("|")]
    return {r for r in rows if r and r != "Layer" and not r.startswith("---")}


def test_layers_are_spelt_alike():
    """A metric's layer is spelt as a row of PERF.md's layers; a new layer
    adds a row there."""
    assert {m["layer"] for m in BENCH["per_layer"]} <= _perf_md_layers()


def test_four_chip_cells_are_few():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("path", sorted(spec.PACKAGE.rglob("*.py")), ids=lambda p: str(p.relative_to(spec.PACKAGE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((spec.PACKAGE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert "theia_tpu_torch" not in _imports(path)
