"""The SpMV kernel's share of its roofline over the traced window, in %:
the least time of its launches (``fem_bench.work.roofline_s`` of the
reduced operator's nonzeros, counted from the mesh input) over their
measured time, summed over every launch whose name matches ``PATTERN``.
Each launch is counted in the value and vector types of its template
arguments."""

from fem_bench.trace import template_args
from fem_bench.work import roofline_s

#: the kernels that count as the SpMV
PATTERN = "bsr_spmv"
BYTES = {"float": 4, "double": 8, "__nv_bfloat16": 2}


def read(run):
    if not run.events or not run.work:
        return None
    bound = measured = 0.0
    for e in run.events:
        if PATTERN not in e.name:
            continue
        args = template_args(e.name)
        values = BYTES.get(args[0] if args else "float", 4)
        vectors = BYTES.get(args[1] if len(args) > 1 else "float", values)
        bound += roofline_s(run.work["nnz"], run.work["rows"], values, vectors)
        measured += (e.end_ns - e.start_ns) / 1e9
    return 100.0 * bound / measured if measured > 0 else None
