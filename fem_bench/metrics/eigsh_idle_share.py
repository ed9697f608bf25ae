"""The share of the eigensolver's time in which no operation ran on the
card: of the traced window's ``fem.eigsh`` spans (spans and device events
share the profiler's clock), the part that no device event covers, in %."""

from fem_bench.spans import overlap_ns, recording
from fem_bench.trace import busy_intervals


def read(run):
    if not run.events:
        return None
    rec = recording(run)
    if rec is None:
        return None
    loops = sorted((s.start_ns, s.end_ns) for s in rec.spans
                   if s.name == "fem.eigsh" and s.request is not None and s.end_ns is not None)
    total = sum(b - a for a, b in loops)
    if total <= 0:
        return None
    busy = [(a, b) for a, b, _, _ in busy_intervals(run.events)]
    return 100.0 * (1.0 - overlap_ns(loops, busy) / total)
