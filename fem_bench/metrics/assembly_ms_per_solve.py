"""Stream time of a request's assembly (the operator's values and the load
vector): the CUDA event pair of each ``fem.assemble`` span, from before
its first launch to after its last, summed over the traced window and
divided by its requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.assemble")
    return None if total is None else total / len(run.latencies_s)
