"""95th percentile over every op of the window of the time from its
batch's submission to its results on the host (nearest rank; every op
carries its batch's latency, and every batch holds the same number of ops,
so this is the nearest-rank p95 of the batches' latencies)."""
import math


def read(rec):
    lat = sorted(rec.get("latencies_s") or [])
    if not lat:
        return None
    return lat[max(0, math.ceil(0.95 * len(lat)) - 1)] * 1e3
