"""The share of the traced window's scattered values that the program's
scatter kernel added: its ``scatter_kernel_values`` counter over its
``scatter_values`` counter (the canonical pairs and the load's values of
every request, on either path), in %."""

from fem_bench.spans import recording


def read(run):
    rec = recording(run)
    if rec is None or not rec.counters.get("scatter_values"):
        return None
    return 100.0 * rec.counters.get("scatter_kernel_values", 0) / rec.counters["scatter_values"]
