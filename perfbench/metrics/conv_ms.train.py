"""Device ms a train step in cuDNN's convolution kernels (the heads' ladders)."""

from perfbench.readers import class_ms_per_unit


def read(r):
    return class_ms_per_unit(r, "conv (cuDNN)")
