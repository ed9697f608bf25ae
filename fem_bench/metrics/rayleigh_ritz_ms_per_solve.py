"""Stream time of a request's dense Rayleigh-Ritz steps in the eigensolver
(the Gram products, the whitening and the ``eigh`` calls): the CUDA event
pair of each ``fem.eigsh.rr`` span, summed over the traced window and
divided by its requests, in ms."""

from fem_bench.spans import device_ms, recording


def read(run):
    rec = recording(run)
    total = None if rec is None else device_ms(rec, "fem.eigsh.rr")
    return None if total is None else total / len(run.latencies_s)
