"""The served forward's share of the card's TF32 dense peak (495 TFLOP/s,
its fastest rate for float32 inputs): the backbone's forward FLOPs an image
times the window's images a second."""

from perfbench import flops
from perfbench.readers import mfu_pct


def read(r):
    return mfu_pct(flops.serve_flops_per_image(r.cfg), r.window.get("serve_images_per_s"), "tf32")
