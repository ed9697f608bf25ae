"""The share of the traced window in which no operation ran on the card:
1 - (union of the device events' intervals) / (window), in %."""

from fem_bench.trace import busy_s


def read(run):
    if not run.events or run.window_s <= 0:
        return None
    return 100.0 * (1.0 - busy_s(run.events) / run.window_s)
