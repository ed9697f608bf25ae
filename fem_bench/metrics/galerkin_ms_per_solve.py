"""Stream time of a request's Galerkin coarse matrix of the M, symmetrised:
the CUDA event pair of each ``fem.precond_setup.galerkin`` span (inside
``fem.precond_setup``), summed over the traced window and divided by its
requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.precond_setup.galerkin")
    return None if total is None else total / len(run.latencies_s)
