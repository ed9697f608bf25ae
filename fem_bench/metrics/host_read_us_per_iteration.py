"""Host time in the PCG loops' blocking reads (the stop tests): the summed
``fem.host_read`` spans inside ``fem.pcg`` over the traced window's PCG
iterations, in us."""

from fem_bench.spans import children, recording


def read(run):
    rec = recording(run)
    if rec is None or not sum(run.iterations):
        return None
    reads = children(rec.spans, "fem.pcg", "fem.host_read")
    return sum(s.end_ns - s.start_ns for s in reads) / 1e3 / sum(run.iterations)
