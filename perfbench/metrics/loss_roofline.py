"""K5 + K6 (the fused distillation loss) against their roofline: one call
of each a teacher a step, bf16 predictions against float32 targets."""

from perfbench import flops
from perfbench.readers import roofline_pct


def read(r):
    recipe = r.traffic["recipe"]
    calls = flops.loss_step_calls(r.cfg, r.batch, recipe["compute_dtype"], recipe["loss_dtype"])
    return roofline_pct(r, calls, ("loss_sums_partial", "loss_sums_finish", "loss_sums_bwd"))
