"""Device ms an extraction batch in cuBLAS's matrix products (the encoder's
dense layers and the relative-position tables' products)."""

from perfbench.readers import class_ms_per_unit


def read(r):
    return class_ms_per_unit(r, "GEMM (cuBLAS)")
