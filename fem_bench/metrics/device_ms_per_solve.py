"""Device time of the traced window's kernels and copies, summed, over its
requests, in ms."""


def read(run):
    if not run.events or not run.latencies_s:
        return None
    return sum(e.end_ns - e.start_ns for e in run.events) / 1e6 / len(run.latencies_s)
