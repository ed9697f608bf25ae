"""The share of the card's idle time in which the host was issuing a PCG
loop: of the gaps between the traced window's busy intervals, the part
that overlaps the ``fem.pcg`` spans less their ``fem.host_read`` children
(spans and device events share the profiler's clock), in %."""

from fem_bench.spans import idle_gaps, overlap_ns, recording, self_intervals


def read(run):
    if not run.events:
        return None
    rec = recording(run)
    gaps = idle_gaps(run.events)
    idle = sum(b - a for a, b in gaps)
    if rec is None or idle <= 0:
        return None
    own = self_intervals(rec.spans, "fem.pcg", "fem.host_read")
    return 100.0 * overlap_ns(own, gaps) / idle
