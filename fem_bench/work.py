"""The work of a kernel, counted from the mesh input and not from the
program's data layout.

``reduced_nonzeros`` counts the nonzeros of the reduced operator: the
pairs of interior nodes that share a cell. ``spmv_bytes`` is what one
product with that operator has to move at the least: each nonzero's value
and a 4-byte column index, the 4-byte row pointer, the input vector read
once and the output written once. ``roofline_s`` divides by the published
peaks of one NVIDIA H100 SXM at 700 W (its data sheet: 3.35 TB/s of HBM3,
67 TFLOP/s in float32 and 34 in float64 outside the tensor cores), taking
the larger of the byte and the operation bound.
"""

from __future__ import annotations

import numpy as np

HBM_BYTES_PER_S = 3.35e12
#: operations per second outside the tensor cores, by value width in bytes
OPS_PER_S = {2: 67e12, 4: 67e12, 8: 34e12}


def reduced_nonzeros(cells: np.ndarray, dirichlet: np.ndarray) -> tuple[int, int]:
    """(nonzeros, rows) of the operator on the interior nodes."""
    cells = np.asarray(cells, dtype=np.int64)
    interior = ~np.asarray(dirichlet, dtype=bool)
    n = int(interior.sum())
    number = np.full(len(interior), -1, dtype=np.int64)
    number[interior] = np.arange(n)
    num = number[cells]
    k = cells.shape[1]
    rows = np.repeat(num, k, axis=1).reshape(-1)
    cols = np.tile(num, (1, k)).reshape(-1)
    keep = (rows >= 0) & (cols >= 0)
    return int(np.unique(rows[keep] * n + cols[keep]).size), n


def spmv_bytes(nnz: int, rows: int, value_bytes: int, vector_bytes: int) -> int:
    return nnz * (value_bytes + 4) + (rows + 1) * 4 + 2 * rows * vector_bytes


def roofline_s(nnz: int, rows: int, value_bytes: int, vector_bytes: int) -> float:
    """The least time of one product on the card."""
    return max(spmv_bytes(nnz, rows, value_bytes, vector_bytes) / HBM_BYTES_PER_S,
               2 * nnz / OPS_PER_S[value_bytes])
