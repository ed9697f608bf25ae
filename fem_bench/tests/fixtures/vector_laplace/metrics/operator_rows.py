"""The rows of the operator that the SpMV applies, as the problem counts them."""


def read(run):
    return float(run.work["rows"]) if run.work else None
