"""K12 (SAM's attention with its decomposed relative-position bias) against
its roofline: one call a layer an extraction batch, 32 at SAM-H's depth,
float32 FLOPs over the TF32 peak or its bytes over the bandwidth."""

from perfbench import sam_flops
from perfbench.readers import roofline_pct


def read(r):
    return roofline_pct(r, sam_flops.relpos_attn_batch_calls(r.cfg, r.batch), ("relpos_attn",))
