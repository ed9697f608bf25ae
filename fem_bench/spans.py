"""The program's own spans and counters of a traced window, for the metric
readers that read them.

The port records them itself (``pytorch_fem_solver_tpu_torch.utils.profiling``:
``recorded()`` returns the spans, stamped with ``time.time_ns()`` as the
profiler's device events are, and the counters) while the window's
profiler runs; set-up's construction spans are recorded always. A program
without that recorder, or a window whose requests it did not record one
``fem.solve`` each, gives nothing to read. All arithmetic on the spans is
here and in the readers, none of it in the program.
"""

from __future__ import annotations

from .trace import busy_intervals


def recording(run):
    """The program's recording, or None: where the program has no
    ``recorded()``, where it holds no ``fem.solve``, or where its requests
    (one id per outermost ``fem.solve``) are not the window's, one for one."""
    try:
        from pytorch_fem_solver_tpu_torch.utils.profiling import recorded
    except ImportError:
        return None
    rec = recorded()
    requests = {s.request for s in rec.spans if s.name == "fem.solve"}
    if not requests or len(requests) != len(run.latencies_s):
        return None
    return rec


def children(spans, parent: str, name: str):
    """The closed spans ``name`` whose parent is a span ``parent``."""
    return [s for s in spans
            if s.name == name and s.parent is not None and s.end_ns is not None
            and spans[s.parent].name == parent]


def self_intervals(spans, name: str, child: str) -> list[tuple[int, int]]:
    """``[start, end)`` pieces of each closed span ``name`` that none of its
    direct ``child`` spans covers, by start."""
    cut: dict[int, list] = {}
    for s in spans:
        if s.name == child and s.parent is not None and s.end_ns is not None:
            cut.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = []
    for k, s in enumerate(spans):
        if s.name != name or s.end_ns is None:
            continue
        at = s.start_ns
        for a, b in sorted(cut.get(k, ())):
            if a > at:
                out.append((at, min(a, s.end_ns)))
            at = max(at, b)
        if at < s.end_ns:
            out.append((at, s.end_ns))
    out.sort()
    return out


def idle_gaps(events) -> list[tuple[int, int]]:
    """The gaps between the device's busy intervals, by start."""
    spans = busy_intervals(events)
    return [(end, start) for (_, end, _, _), (start, _, _, _) in zip(spans, spans[1:])]


def overlap_ns(a: list, b: list) -> int:
    """The length of the intersection of two sorted lists of disjoint
    ``(start, end)`` intervals."""
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_ms(rec, name: str):
    """The summed ``device_ms`` of the window's spans ``name`` (their CUDA
    event pairs), or None where any has none (off the card)."""
    values = [s.device_ms for s in rec.spans if s.name == name and s.request is not None]
    if not values or any(v is None for v in values):
        return None
    return sum(values)
