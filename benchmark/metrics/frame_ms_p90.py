"""frame_ms_p90: the 90th percentile of every frame's latency in the window (ms)."""
from benchmark.harness import readers


def read(r):
    if r["mode"] != "serve":
        return None
    p = readers.percentile(r["latency_s"], 90)
    return None if p is None else p * 1e3
