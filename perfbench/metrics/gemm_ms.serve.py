"""Device ms a served batch in cuBLAS's matrix products (the backbone's)."""

from perfbench.readers import class_ms_per_unit


def read(r):
    return class_ms_per_unit(r, "GEMM (cuBLAS)")
