"""Host time of the PCG loops other than their blocking reads: the summed
``fem.pcg`` spans of the traced window less their ``fem.host_read``
children, over the window's PCG iterations, in us."""

from fem_bench.spans import recording, self_intervals


def read(run):
    rec = recording(run)
    if rec is None or not sum(run.iterations):
        return None
    own = self_intervals(rec.spans, "fem.pcg", "fem.host_read")
    return sum(b - a for a, b in own) / 1e3 / sum(run.iterations)
