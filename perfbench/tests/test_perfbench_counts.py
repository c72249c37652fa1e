"""``perfbench/flops.py`` against hand counts and against the byte counts of
PERF.md's kernel table (K1 77.5, K3 239.1, K4 314.6, K5 195.0, K6 260.0 MB)."""

from __future__ import annotations

import pytest

from perfbench import flops, spec
from perfbench.readers import Readings, idle_pct, roofline_pct
from perfbench.tests import tiny
from perfbench.trace import Kernel, Trace

BASE = spec.load_json(spec.PACKAGE / "configs" / "theia-base-cddsv.json")


def test_backbone_flops_by_hand():
    cfg = tiny.config()  # C 192, MLP 768, 2 layers, 14² patches + CLS
    embed = 2 * 196 * 192 * 768
    dense = 2 * 197 * 192 * (3 * 192 + 192 + 2 * 768)
    attn = 2 * 2 * 197 * 197 * 192
    assert flops.backbone_forward_flops(cfg) == embed + 2 * (dense + attn)


def test_head_flops_by_hand():
    cfg = tiny.config()  # a 16² teacher of 64 channels and a 64² teacher of 16
    pad = 2 * 192 * 192 * 196 * 9
    same = pad + 2 * (2 * 192 * 192 * 256 * 9) + 2 * 192 * 64 * 256
    up = pad + 2 * 192 * 192 * 256 * 9 + 2 * 192 * 192 * 961 * 9 + 2 * 192 * 16 * 4096
    assert flops.heads_forward_flops(cfg) == same + up
    assert flops.train_flops_per_image(cfg) == 3 * (flops.backbone_forward_flops(cfg) + same + up)
    assert flops.serve_flops_per_image(cfg) == flops.backbone_forward_flops(cfg)


def test_base_model_flops():
    """Theia-Base cddsv: ~35 GFLOP a backbone forward, ~91 with the five heads."""
    assert flops.backbone_forward_flops(BASE) == pytest.approx(35.1e9, rel=0.01)
    assert flops.backbone_forward_flops(BASE) + flops.heads_forward_flops(BASE) == pytest.approx(90.8e9, rel=0.01)


@pytest.mark.parametrize("call, mb", [
    (flops.mha_fwd_call(64, 197, 12, 64, "bfloat16"), 77.5),
    (flops.ln_bwd_stats_call(16, 768, 64, 64, "bfloat16"), 239.1),
    (flops.ln_bwd_dx_call(16, 768, 64, 64, "bfloat16"), 314.6),
])
def test_kernel_bytes_match_the_table(call, mb):
    assert call.bytes / 1e6 == pytest.approx(mb, abs=0.05)


def test_loss_bytes_match_the_table():
    """K5 and K6 over the five teachers at B = 16, bf16 predictions, float32 targets."""
    calls = flops.loss_step_calls(BASE, 16, "bfloat16")
    fwd, bwd = calls[0::2], calls[1::2]
    assert sum(c.bytes for c in fwd) / 1e6 == pytest.approx(195.0, abs=0.05)
    assert sum(c.bytes for c in bwd) / 1e6 == pytest.approx(260.0, abs=0.05)


def test_bounds():
    """K3 at [16,768,64,64] bf16: bytes bound 0.0714 ms (the table's); K1
    float32 at [64,197,12,64]: 0.0462 ms, bytes over 3.35 TB/s above the
    TF32 FLOP bound."""
    assert flops.ln_bwd_stats_call(16, 768, 64, 64, "bfloat16").bound_s() * 1e3 == pytest.approx(0.0714, abs=5e-4)
    k1 = flops.mha_fwd_call(64, 197, 12, 64, "float32")
    assert k1.flops == pytest.approx(7.63e9, rel=1e-3)
    assert k1.bound_s() * 1e3 == pytest.approx(0.0462, abs=5e-4)


def test_a_steps_sites():
    """15 LayerNormSpatial sites a step: 11 at 16², 2 at 31², 2 at 64²."""
    sites = flops.ln_spatial_sites(BASE)
    assert len(sites) == 15
    assert sorted(h for _, h, _ in sites) == [16] * 11 + [31] * 2 + [64] * 2
    assert len(flops.ln_bwd_step_calls(BASE, 128, "bfloat16")) == 30
    assert len(flops.attn_fwd_batch_calls(BASE, 64, "float32")) == 12


def _roofline(names: list[str], calls: list[flops.Call], keys: tuple[str, ...], units: int, us: float):
    trace = Trace(kernels=[Kernel(n, 10.0 * i, us, i) for i, n in enumerate(names)])
    return roofline_pct(Readings(BASE, {}, {}, 64, units, trace, {}), calls, keys)


@pytest.mark.parametrize("left_out", [0, 1])
def test_attention_roofline_reads_only_every_traced_call(left_out):
    """Two batches' 24 K1 calls, each twice its bound: 50%; one record
    short, nothing is read."""
    calls = flops.attn_fwd_batch_calls(BASE, 64, "float32")
    us = 2e6 * calls[0].bound_s()
    got = _roofline(["mha_fwd_f32"] * (24 - left_out), calls, ("mha_fwd",), 2, us)
    assert got == (pytest.approx(50.0) if not left_out else None)


@pytest.mark.parametrize("finish", [True, False])
def test_loss_roofline_counts_k5_as_two_launches(finish):
    """A step's K5 (partial and finish) and K6 a teacher: 15 kernels; the
    10 of a K5 without its finish read nothing."""
    calls = flops.loss_step_calls(BASE, 64, "bfloat16")
    names = ["loss_sums_partial", "loss_sums_bwd"] * 5 + (["loss_sums_finish"] * 5 if finish else [])
    got = _roofline(names, calls, ("loss_sums_partial", "loss_sums_finish", "loss_sums_bwd"), 1, 100.0)
    if finish:
        assert got == pytest.approx(100.0 * sum(c.bound_s() for c in calls) / 15e-4)
    else:
        assert got is None


def test_idle_is_the_windows():
    """Two traced steps busy 150 ms each (two overlapping kernels a step),
    in a window of 10 steps over 2.5 s: 40% idle, whatever the traced span."""
    kernels = [Kernel("k", 0.0, 100e3, 0), Kernel("k", 50e3, 100e3, 1), Kernel("k", 900e3, 150e3, 2)]
    r = Readings(BASE, {}, {}, 128, 2, Trace(kernels=kernels), {"seconds": 2.5, "done": 10})
    assert idle_pct(r) == pytest.approx(40.0)
    assert idle_pct(Readings(BASE, {}, {}, 128, 2, None, {"seconds": 2.5, "done": 10})) is None
