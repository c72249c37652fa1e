"""The extraction's share of the card's TF32 dense peak (495 TFLOP/s, its
fastest rate for float32 inputs): the SAM encoder's forward FLOPs an image
(``perfbench/sam_flops.py``) times the window's images a second."""

from perfbench import sam_flops
from perfbench.readers import mfu_pct


def read(r):
    return mfu_pct(sam_flops.forward_flops_per_image(r.cfg), r.window.get("serve_images_per_s"), "tf32")
