"""PCG iterations a request, averaged over the window's requests, as the
program reports them (``PCGInfo.iterations``; a refined solve's stages
summed from ``RefineInfo.inner_iterations``)."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
