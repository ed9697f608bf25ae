"""Eigensolver rounds a request (the program's ``eigsh_rounds`` counter over
the traced window, over its requests)."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None or "eigsh_rounds" not in rec.counters:
        return None
    return rec.counters["eigsh_rounds"] / len(run.latencies_s)
