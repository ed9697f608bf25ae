"""Seconds from the process's start to the first request of the window:
the interpreter, the imports, the mesh input, the program's tables, the
kernels' build or load and the warm-up requests."""


def read(run):
    return run.setup_s
