"""The train step's share of the card's bf16 dense peak (989 TFLOP/s): the
model FLOPs of a trained image (forward ×3, counted from the configuration's
shapes) times the window's images a second."""

from perfbench import flops
from perfbench.readers import mfu_pct


def read(r):
    return mfu_pct(flops.train_flops_per_image(r.cfg), r.window.get("train_images_per_s"), "bfloat16")
