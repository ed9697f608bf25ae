"""The share of the traced window's PCG iterations that ran inside replays
of a captured CUDA graph: the program's ``pcg_graphed_iterations`` counter
over the window's iterations, in %."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None or "pcg_graphed_iterations" not in rec.counters or not sum(run.iterations):
        return None
    return 100.0 * rec.counters["pcg_graphed_iterations"] / sum(run.iterations)
