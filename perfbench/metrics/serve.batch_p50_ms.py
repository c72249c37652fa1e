"""The median batch latency of the window: from the moment a batch is
handed to ``predict_stream`` until its result is a host array."""

import statistics


def read(r):
    lat = r.window.get("latencies_ms")
    return statistics.median(lat) if lat else None
