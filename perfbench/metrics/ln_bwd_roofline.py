"""K3 + K4 (LayerNormSpatial's backward) against their roofline: the bound
of every call a step makes, from the configuration's map shapes and the
recipe's compute dtype, over the kernels' device time."""

from perfbench import flops
from perfbench.readers import roofline_pct


def read(r):
    calls = flops.ln_bwd_step_calls(r.cfg, r.batch, r.traffic["recipe"]["compute_dtype"])
    return roofline_pct(r, calls, ("ln_bwd_stats", "ln_bwd_dx"))
