"""The eigensolver's block products' share of their roofline over the
traced window, in %: the least time of every ``fem.eigsh.product`` of the
window over their measured time (the spans' CUDA event pairs).

The least time counts the work of a block product, whatever implements it:
one read of the reduced operator's values, column indices and row pointer
(nnz (v + 4) + (rows + 1) 4 bytes, v the value's bytes) a product, and one
input and one output vector (2 rows v bytes) and 2 nnz operations a column,
from the program's ``eigsh_products`` and ``eigsh_product_columns``
counters and the operator counted from the mesh input (the problem's work:
``nnz``, ``rows``, ``value_bytes``). The byte and the operation bounds are
taken over the window's sums, the larger of the two (``fem_bench.work``'s
peaks): never more than the sum of each product's own bound, so the share
stays at or under the true one."""

from fem_bench.spans import device_ms, recording
from fem_bench.work import HBM_BYTES_PER_S, OPS_PER_S


def least_bytes(nnz: int, rows: int, products: int, columns: int, value_bytes: int = 4) -> int:
    """The bytes that ``products`` block products of ``columns`` columns in
    all have to move at the least."""
    return (products * (nnz * (value_bytes + 4) + (rows + 1) * 4)
            + columns * 2 * rows * value_bytes)


def read(run):
    rec = recording(run)
    if rec is None or not run.work:
        return None
    products = rec.counters.get("eigsh_products", 0)
    columns = rec.counters.get("eigsh_product_columns", 0)
    measured = device_ms(rec, "fem.eigsh.product")
    if not products or not measured:
        return None
    nnz, rows, v = run.work["nnz"], run.work["rows"], run.work.get("value_bytes", 4)
    bound = max(least_bytes(nnz, rows, products, columns, v) / HBM_BYTES_PER_S,
                2 * nnz * columns / OPS_PER_S[v])
    return 100.0 * bound / (measured / 1e3)
