"""K1 (the exact attention's forward) against its roofline: one call a
layer a served batch, float32 FLOPs over the TF32 peak."""

from perfbench import flops
from perfbench.readers import roofline_pct


def read(r):
    calls = flops.attn_fwd_batch_calls(r.cfg, r.batch, r.traffic["dtype"])
    return roofline_pct(r, calls, ("mha_fwd",))
