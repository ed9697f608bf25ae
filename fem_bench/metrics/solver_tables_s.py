"""Host seconds of building the solver at set-up (the program's
``fem.tables.solver`` span: the BSR layout, the preconditioner's tables;
``tables_s`` less the basis): the last one that ended before the window's
first request."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None:
        return None
    first = min(s.start_ns for s in rec.spans if s.name == "fem.solve")
    built = [s for s in rec.spans if s.name == "fem.tables.solver" and s.parent is None
             and s.end_ns is not None and s.end_ns <= first]
    return (built[-1].end_ns - built[-1].start_ns) / 1e9 if built else None
