"""The collective audit of the port (``parallel/audit.py``) for a data-
parallel step and a TP(2) step over two gloo processes on the CPU, against
the communication claims of the JAX package's audit
(tests/test_collective_audit.py).

The port issues each collective by hand, and ``summarize`` keys them as the
JAX audit keys the compiled program's: ``"<kind>@g<group size>"``. The
counts differ from the JAX program's by design: GSPMD also reshards
between layouts (all-to-all and collective-permute records, none here),
fuses some all-reduces into tuples and all-gathers split predictions for
its loss, where the port all-reduces the fused loss's per-sample sums
instead; the port adds one all-reduce of the replicated gradients over the
model group, which keeps the ranks' replicated parameters bit-equal (the
JAX program holds one copy of them). What both must show is what is
asserted: DP moves the float32 gradients once, plus the metrics; TP cuts
each block with one all-reduce after attention and one after the MLP; and
the 64x64 head's row-parallel all-reduce carries the payload the JAX
audit shows for the same step.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tp import SMALL, TARGETS, _collect, _launch, _save_batch, _targets
from theia_tpu.models import vit as jvit
from theia_tpu.models.rvfm import Theia as JTheia
from theia_tpu.parallel.audit import audit_compiled
from theia_tpu.parallel.mesh import make_mesh
from theia_tpu.parallel.tp import tp_specs, train_state_shardings
from theia_tpu.train.optim import constant_with_warmup, make_optimizer
from theia_tpu.train.state import TrainState as JTrainState
from theia_tpu.train.step import make_train_step as jmake_train_step
from theia_tpu_torch.models import vit as tvit
from theia_tpu_torch.models.convert import state_dict_from_jax
from theia_tpu_torch.parallel.audit import audit, record, summarize

TARGETS64 = {"teacher/s": (32, 64, 64)}
ROWS, ROWS64 = 4, 2
T, C = 197, 384  # deit-small's tokens and width


def _jax_audit64(images, targets):
    """The JAX package's audit of its TP step on a (1, 2) mesh for the 64x64-head model."""
    jmodel = JTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TARGETS64)
    params = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
    tx = make_optimizer(constant_with_warmup(1e-4, 10), weight_decay=0.01)
    mesh = make_mesh(n_data=1, n_model=2, devices=jax.devices()[:2])
    step = jmake_train_step(jmodel, tx, main_loss="cos_l1", mesh=mesh,
                            state_shardings=train_state_shardings(mesh, tx, params, tp_specs(params, 2)))
    compiled = step._jitted.lower(JTrainState.create(params, tx), jnp.asarray(images),
                                  {t: jnp.asarray(v) for t, v in targets.items()}, None).compile()
    return params, audit_compiled(compiled, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    saved = [(configs, configs[SMALL]) for configs in (jvit.BACKBONE_CONFIGS, tvit.BACKBONE_CONFIGS)]
    for configs, cfg in saved:
        configs[SMALL] = dataclasses.replace(cfg, num_layers=2)
    try:
        tmp = tmp_path_factory.mktemp("tp_audit")
        params = JTheia(backbone=SMALL, translator="lconv", target_feature_sizes=TARGETS).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.uint8))["params"]
        torch.save(state_dict_from_jax(params, TARGETS), tmp / "sd.pt")
        rng = np.random.default_rng(0)
        images = rng.integers(0, 256, (ROWS, 224, 224, 3), dtype=np.uint8)
        names = _save_batch(tmp / "batch.npz", images, _targets(rng, TARGETS, ROWS))
        targets64 = _targets(rng, TARGETS64, ROWS64)
        names64 = _save_batch(tmp / "batch64.npz", images[:ROWS64], targets64)
        out = tmp / "ranks"
        out.mkdir()
        spec = dict(world=2, n_model=2, cases=["dp_audit", "tp_steps", "audit64"], out=str(out),
                    state_dict=str(tmp / "sd.pt"), batch=str(tmp / "batch.npz"), names=names, targets=TARGETS,
                    state_dict64=str(tmp / "sd64.pt"), batch64=str(tmp / "batch64.npz"), names64=names64,
                    targets64=TARGETS64, steps=1, lr=1e-4, clip=1.0)
        jparams64, jaudit = _jax_audit64(images[:ROWS64], targets64)
        torch.save(state_dict_from_jax(jparams64, TARGETS64), tmp / "sd64.pt")
        (out / "spec.json").write_text(json.dumps(spec))
        ranks = _collect(_launch(out / "spec.json", 2), out)
        yield dict(ranks=ranks, jax64=jaudit)
    finally:
        for configs, cfg in saved:
            configs[SMALL] = cfg


def test_summarize_keys_records_as_the_jax_audit_does():
    with audit() as records:
        record("all-reduce", 8, 2)
        record("all-reduce", 4, 2)
        record("all-gather", 16, 4)
    record("all-reduce", 1, 2)  # no audit open: not kept
    assert summarize(records) == {"all-gather@g4": {"count": 1, "bytes": 16},
                                  "all-reduce@g2": {"count": 2, "bytes": 12}}


def test_dp_step_is_one_gradient_all_reduce_and_one_metrics_all_reduce(run):
    """Data parallelism: the float32 gradient bucket once (4 bytes a
    parameter), then the metrics' stack (the loss, 3 terms, 3 a teacher)."""
    rec = run["ranks"][0]["dp_audit"]
    n_metrics = 4 + 3 * len(TARGETS)
    assert rec["records"] == [{"kind": "all-reduce", "bytes": 4 * rec["n_params"], "group_size": 2},
                              {"kind": "all-reduce", "bytes": 4 * n_metrics, "group_size": 2}]
    assert summarize(rec["records"]) == {"all-reduce@g2": {"count": 2, "bytes": 4 * (rec["n_params"] + n_metrics)}}


def test_tp_step_cuts_each_block_with_two_all_reduces_forward(run):
    """TP(2), one data index: the forward opens with each block's two
    row-parallel all-reduces of [B, T, C] float32 (attention, MLP), the
    backward sends the column-parallel inputs' gradients back as many;
    every collective spans the model group."""
    records = run["ranks"][0]["tp"]["records"]
    block = 4 * ROWS * T * C
    assert [r["bytes"] for r in records[:4]] == [block] * 4  # 2 layers x (attention, MLP), forward
    assert sum(r["bytes"] == block for r in records) == 8  # and their 4 copies' gradients
    assert all(r["group_size"] == 2 for r in records)
    summary = summarize(records)
    n_model_ars = summary["all-reduce@g2"]["count"]
    # the forward: 4 block cuts; teacher/a's split LayerNorm sums,
    # row-parallel conv and fused loss sums; teacher/c's split LayerNorm
    # sums and row-parallel Dense; teacher/a_cls's fused loss sums.
    # The backward: 4 block copies; teacher/a's two column-parallel inputs
    # (conv, Dense) and its LayerNorm's s1, s2; teacher/c's column-parallel
    # conv input and LayerNorm s1, s2; the two _cls Linears' inputs.
    # Then the replicated gradients' bucket and the clip norm's split squares.
    assert n_model_ars == (4 + 3 + 2 + 1) + (4 + 3 + 2 + 1 + 1) + (1 + 1)
    # teacher/b_cls's 48 features are below the fused loss's 1024: its
    # prediction and target are gathered whole
    assert summary["all-gather@g2"] == {"count": 2, "bytes": 2 * 4 * ROWS * 48}


def test_64x64_head_row_parallel_all_reduce_has_the_jax_payload(run):
    """The 16 -> 64 ladder's row-parallel ConvTranspose: one all-reduce of
    its [B, hidden, 64, 64] float32 partial sums, the payload of the JAX
    audit's model-axis all-reduce for the same step
    (B/n_data * 64*64 * 2C * 2, tests/test_collective_audit.py)."""
    expect = ROWS64 * 64 * 64 * (2 * C) * 2
    jax_hits = [r for r in run["jax64"]["records"]
                if r["kind"] == "all-reduce" and r["group_size"] == 2 and r["bytes"] == expect]
    assert jax_hits
    port = run["ranks"][0]["audit64"]["records"]
    # the forward's, and the gradient of the last (column-parallel) Dense's
    # [B, 64*64, hidden] input, of the same size
    assert [r["group_size"] for r in port if r["bytes"] == expect] == [2, 2]
    assert all(r["group_size"] == 2 for r in port)
