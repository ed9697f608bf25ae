"""The 95th percentile (nearest rank) of every request's latency in the
window, in ms; a request that did not converge counts as infinitely late,
and a percentile that lands on one is not reported."""

import math


def read(run):
    lat = sorted(t if ok else math.inf for t, ok in zip(run.latencies_s, run.converged))
    if not lat:
        return None
    p95 = lat[math.ceil(0.95 * len(lat)) - 1]
    return 1e3 * p95 if math.isfinite(p95) else None
