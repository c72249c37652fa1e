"""Device kernels a train step: the kernels in the traced steps over the steps."""


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return len(r.trace.kernels) / r.units
