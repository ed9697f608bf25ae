"""Kernel launches in the traced window (device events other than copies
and sets) over the window's PCG iterations."""


def read(run):
    if not run.events or not sum(run.iterations):
        return None
    return sum(not e.copy for e in run.events) / sum(run.iterations)
