"""Host time of a request's capture and instantiation of its PCG loop's CUDA
graph: the ``fem.pcg.capture`` spans (inside ``fem.pcg``) of the traced
window's requests, summed and divided by its requests, in ms."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None:
        return None
    spans = [s for s in rec.spans
             if s.name == "fem.pcg.capture" and s.request is not None and s.end_ns is not None]
    if not spans:
        return None
    return sum(s.end_ns - s.start_ns for s in spans) / 1e6 / len(run.latencies_s)
