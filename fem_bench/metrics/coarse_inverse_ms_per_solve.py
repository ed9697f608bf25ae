"""Stream time of a request's inverse of the M's shifted coarse matrix
(``spd_inverse``): the CUDA event pair of each
``fem.precond_setup.coarse_inverse`` span (inside
``fem.precond_setup``), summed over the traced window and divided by its
requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.precond_setup.coarse_inverse")
    return None if total is None else total / len(run.latencies_s)
