"""``torch.cuda.max_memory_allocated()`` over the window, reset at its
start, in GiB (not reported off the card)."""


def read(run):
    return run.peak_window_bytes / 2**30 if run.peak_window_bytes else None
