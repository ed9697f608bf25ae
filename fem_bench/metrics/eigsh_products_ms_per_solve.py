"""Stream time of a request's A- and M-block products in the eigensolver:
the CUDA event pair of each ``fem.eigsh.product`` span, summed over the
traced window and divided by its requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.eigsh.product")
    return None if total is None else total / len(run.latencies_s)
