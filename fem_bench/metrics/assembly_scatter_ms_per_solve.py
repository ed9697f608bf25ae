"""Stream time of a request's scatter of the element matrices into the BSR
values (with the mirror completion) and of the element loads into the
padded load: the CUDA event pair of each ``fem.assemble.scatter`` span
(inside ``fem.assemble``), summed over the traced window and divided by
its requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.assemble.scatter")
    return None if total is None else total / len(run.latencies_s)
