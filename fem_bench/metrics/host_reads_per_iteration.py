"""Blocking device-to-host reads of the program in the traced window (its
``host_reads`` counter: every stop test, the preconditioner's set-up
checks) over the window's PCG iterations."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None or not sum(run.iterations):
        return None
    return rec.counters.get("host_reads", 0) / sum(run.iterations)
