"""Rows of the coarse matrix a request's M sets up (the program's
``coarse_rows`` counter over the traced window, over its requests): na m
of the rigid-body-mode M, n_pad / g of the aggregate-block one."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None or "coarse_rows" not in rec.counters:
        return None
    return rec.counters["coarse_rows"] / len(run.latencies_s)
