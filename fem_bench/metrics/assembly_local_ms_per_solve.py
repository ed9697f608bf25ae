"""Stream time of a request's element matrices and element loads, per run
of cells: the CUDA event pair of each ``fem.assemble.local`` span
(inside ``fem.assemble``), summed over the traced window and divided by
its requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.assemble.local")
    return None if total is None else total / len(run.latencies_s)
