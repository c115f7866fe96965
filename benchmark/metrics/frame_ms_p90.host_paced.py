"""frame_ms_p90.host_paced: frame_ms_p90 where the host paces the card (ms);
read in the traced run, as a per-layer metric."""
from benchmark.harness import readers


def read(r):
    if r["mode"] != "serve":
        return None
    p = readers.percentile(r["latency_s"], 90)
    return None if p is None else p * 1e3
