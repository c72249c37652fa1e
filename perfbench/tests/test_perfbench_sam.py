"""The SAM configuration and its cell: the files resolve, the new metrics'
layers are PERF.md's, and on the CPU at a small size (hidden 64, 4 heads, 4
layers, global at [1, 3], window 3 on an 8² grid, so padded to 9²) a whole
run of ``sam-extract-b32`` through ``extract_batch`` comes out correct,
while each planted fault comes out not correct: the bias dropped in the
global layers, the padded keys masked in the windows, and the control (the
program's dense products with their operands rounded to TF32, as a card's
TF32 matmuls round them)."""

from __future__ import annotations

import copy
import json
import time

import pytest
import torch

from perfbench import sam_flops, spec
from perfbench.drivers import extract
from perfbench.run import run_cell
from perfbench.tests.test_perfbench_harness import _perf_md_layers

CELL = "sam-extract-b32"
BENCH = spec.benchmark()
NEW = ["device_idle_pct.extract", "mfu.extract", "gemm_ms.extract", "relpos_attn_roofline",
       "extract.readback_idle_ms", "sam.attn_launches"]


def small_config() -> dict:
    cfg = spec.load_json(spec.PACKAGE / "configs" / "sam-vit-huge.json")
    cfg.update(name="sam-small", hidden_size=64, num_attention_heads=4, num_hidden_layers=4, global_attn_indexes=[1, 3],
               image_size=128, mlp_dim=256, output_channels=32, window_size=3, input_size=56)
    return cfg


def small_bench(tmp) -> dict:
    path = tmp / "sam-small.json"
    path.write_text(json.dumps(small_config()))
    b = copy.deepcopy(BENCH)
    b["configs"].append({"name": "sam-small", "source": "test", "file": str(path), "reduced": [], "why": "test"})
    for w in b["workloads"]:
        if w["name"] == CELL:
            w["config"] = "sam-small"
    return b


def _run(tmp_path) -> dict:
    cell = dict(spec.load_json(spec.cell_file(CELL)), batch=3)
    result, _ = run_cell(CELL, 2**31 + 4321, 0.5, False, torch.device("cpu"), time.perf_counter(),
                         small_bench(tmp_path), cell)
    return result


def test_the_new_files_resolve():
    entry = spec.cell_entry(BENCH, CELL)
    cfg = spec.load_json(spec.ROOT / spec.config_entry(BENCH, entry["config"])["file"])
    assert cfg["reduced"] == [] and (cfg["hidden_size"], cfg["num_hidden_layers"], cfg["mlp_dim"]) == (1280, 32, 5120)
    traffic = spec.load_json(spec.traffic_file(entry["traffic"]))
    assert spec.driver_class(traffic["driver"]) is extract.Driver
    assert spec.load_json(spec.cell_file(CELL))["batch"] == 32
    assert [m["name"] for m in spec.per_layer_for(BENCH, CELL)] == NEW
    assert {m["name"] for m in spec.end_to_end_for(BENCH, CELL)} == {"serve_images_per_s", "setup_s"}
    for name in NEW:
        assert callable(spec.metric_reader(name).read)


def test_the_new_metrics_layers_are_perf_mds_rows():
    layers = {m["name"]: m["layer"] for m in BENCH["per_layer"]}
    assert {layers[n] for n in NEW} <= _perf_md_layers()
    assert layers["extract.readback_idle_ms"] == "extraction"


def test_the_roofline_counts_one_call_a_layer():
    calls = sam_flops.relpos_attn_batch_calls(small_config(), 3)
    assert len(calls) == 4 and calls[1].flops == 4.0 * 3 * 4 * 64 ** 2 * 16


def test_a_sound_run_is_correct(tmp_path):
    result = _run(tmp_path)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] >= 1
    assert result["check"]["feature_rel_l2"]["value"] < result["check"]["feature_rel_l2"]["limit"]
    assert result["check"]["feature_rel_l2_f32"]["value"] < 1e-5


def test_the_bias_dropped_in_the_global_layers(tmp_path, monkeypatch):
    from theia_tpu_torch.ops import attention

    plain = attention.relpos_attention_plain

    def dropped(q, k, v, rel_pos_h, rel_pos_w, num_heads, h, w, dtype, *args):
        if h == 8:  # the grid: a global layer
            rel_pos_h, rel_pos_w = torch.zeros_like(rel_pos_h), torch.zeros_like(rel_pos_w)
        return plain(q, k, v, rel_pos_h, rel_pos_w, num_heads, h, w, dtype, *args)

    monkeypatch.setattr(attention, "relpos_attention_plain", dropped)
    assert not _run(tmp_path)["correct"]


def test_the_padded_keys_masked(tmp_path, monkeypatch):
    """The 8² grid in windows of 3 is padded to 9²: the last window of a row
    (and of a column) holds a row (a column) of padded keys, which the
    fault masks out of the softmax, where HF and the reference let them in."""
    from theia_tpu_torch.ops import attention

    plain = attention.relpos_attention_plain

    def masked(q, k, v, rel_pos_h, rel_pos_w, num_heads, h, w, dtype, *args):
        if h == 8:  # a global layer: no padding
            return plain(q, k, v, rel_pos_h, rel_pos_w, num_heads, h, w, dtype, *args)
        b, t, c = q.shape
        hd = c // num_heads
        pos = torch.arange(w)
        real = torch.stack([((wy * w + pos)[:, None] < 8) & ((wx * w + pos)[None, :] < 8)
                            for wy in range(3) for wx in range(3)]).reshape(9, t)
        keep = real.repeat(b // 9, 1)  # windows in (image, row, column) order
        qh, kh, vh = (y.reshape(b, t, num_heads, hd).transpose(1, 2) for y in (q, k, v))
        idx = pos[:, None] - pos[None, :] + w - 1
        qs = qh.reshape(b, num_heads, w, w, hd)
        rel_h = torch.einsum("bnhwc,hkc->bnhwk", qs, rel_pos_h[idx])
        rel_w = torch.einsum("bnhwc,wkc->bnhwk", qs, rel_pos_w[idx])
        scores = torch.matmul(qh * hd ** -0.5, kh.transpose(-1, -2)).view(b, num_heads, w, w, w, w)
        scores = (scores + rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, num_heads, t, t)
        scores = scores.masked_fill(~keep[:, None, None, :], float("-inf"))
        return torch.matmul(scores.softmax(-1), vh).transpose(1, 2).reshape(b, t, c)

    monkeypatch.setattr(attention, "relpos_attention_plain", masked)
    assert not _run(tmp_path)["correct"]


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest, ties away (the
    tensor cores' rounding of a float32 operand)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32).view(x.shape)


def test_the_tf32_control(tmp_path, monkeypatch):
    from theia_tpu_torch.foundation import sam

    def dense_tf32(m, x, dtype):
        bias = None if m.bias is None else m.bias.to(dtype)
        return torch.nn.functional.linear(_tf32(x), _tf32(m.weight.to(dtype)), bias)

    monkeypatch.setattr(sam, "dense", dense_tf32)
    assert not _run(tmp_path)["correct"]


@pytest.mark.gpu
def test_the_tf32_control_fails_the_cell_on_the_card():
    """The reference with TF32 on, at the cell's own size on the card, one seed: refused."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench.tools import calibrate

    limits = spec.load_json(spec.cell_file(CELL))["limits"]
    rows = calibrate.readings(CELL, 2**31 + 778, True, 3.0, torch.device("cuda", 0))
    control = [r for r in rows if r["side"].startswith("control")]
    # the control's reading is the float32 embeddings' distance; it has to pass every limit of the cell
    assert control and all(r["feature_rel_l2"] > max(limits.values()) for r in control)
