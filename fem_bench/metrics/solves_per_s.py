"""Requests completed in the window over the window's length (closed loop,
one caller; a request that started before the end of ``--seconds``
completes, and the window ends with the last)."""


def read(run):
    return len(run.latencies_s) / run.window_s if run.window_s > 0 else None
