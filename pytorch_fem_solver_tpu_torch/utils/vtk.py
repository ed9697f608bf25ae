"""Legacy-VTK (ASCII) export of meshes and solutions for ParaView/VisIt.

Counterpart of ``pytorch_fem_solver_tpu/utils/vtk.py``: the same
dependency-free legacy ``.vtk`` UNSTRUCTURED_GRID writer for triangle (2D
or embedded 3D, e.g. DFN surfaces) and tetrahedral meshes, with any number
of scalar or vector point fields. Arrays may be tensors on any device or
NumPy arrays; for the same float64 values the file is byte-identical to the
JAX package's.
"""

from __future__ import annotations

import numpy as np

from ..basis.abstract_basis import host

__all__ = ["write_vtk"]

#: legacy VTK cell type ids by local vertex count
_CELL_TYPES = {3: 5, 4: 10}  # VTK_TRIANGLE, VTK_TETRA


def write_vtk(path, vertices, cells, point_data=None, title="pytorch_fem_solver_tpu"):
    """Write an ASCII legacy-VTK unstructured grid.

    Args:
      path: output filename (conventionally ``.vtk``).
      vertices: (N, 2) or (N, 3) coordinates (2D is zero-padded to 3D as
        the format requires).
      cells: (T, 3) triangles or (T, 4) tetrahedra (vertex indices).
      point_data: optional mapping ``name -> (N,) | (N, 1) | (N, 3)``
        array; 1-column arrays are written as SCALARS, 3-column as
        VECTORS. 2-component vector fields (2D displacement) are
        zero-padded to 3.
      title: VTK header comment line.

    Returns ``path``.
    """
    vertices = host(vertices).astype(np.float64)
    cells = host(cells).astype(np.int64)
    if vertices.ndim != 2 or vertices.shape[1] not in (2, 3):
        raise ValueError(f"vertices must be (N, 2|3); got {vertices.shape}")
    if cells.ndim != 2 or cells.shape[1] not in _CELL_TYPES:
        raise ValueError(
            f"cells must be (T, 3) triangles or (T, 4) tets; got {cells.shape}"
        )
    if cells.size and (cells.min() < 0 or cells.max() >= vertices.shape[0]):
        raise ValueError("cell vertex index out of range")
    if vertices.shape[1] == 2:
        vertices = np.concatenate([vertices, np.zeros((vertices.shape[0], 1))], axis=1)
    n_v, n_t = vertices.shape[0], cells.shape[0]
    k = cells.shape[1]
    ctype = _CELL_TYPES[k]

    lines = [
        "# vtk DataFile Version 3.0",
        str(title).splitlines()[0] if title else "mesh",
        "ASCII",
        "DATASET UNSTRUCTURED_GRID",
        f"POINTS {n_v} double",
    ]
    lines.extend(" ".join(f"{x:.17g}" for x in row) for row in vertices)
    lines.append(f"CELLS {n_t} {n_t * (k + 1)}")
    lines.extend(f"{k} " + " ".join(str(int(i)) for i in row) for row in cells)
    lines.append(f"CELL_TYPES {n_t}")
    lines.extend([str(ctype)] * n_t)

    if point_data:
        lines.append(f"POINT_DATA {n_v}")
        for name, arr in point_data.items():
            arr = host(arr).astype(np.float64)
            if arr.ndim == 1:
                arr = arr[:, None]
            if arr.shape[0] != n_v:
                raise ValueError(
                    f"point_data[{name!r}] has {arr.shape[0]} rows for {n_v} points"
                )
            safe = str(name).replace(" ", "_")
            if arr.shape[1] == 1:
                lines.append(f"SCALARS {safe} double 1")
                lines.append("LOOKUP_TABLE default")
                lines.extend(f"{x:.17g}" for x in arr[:, 0])
            elif arr.shape[1] in (2, 3):
                if arr.shape[1] == 2:
                    arr = np.concatenate([arr, np.zeros((n_v, 1))], axis=1)
                lines.append(f"VECTORS {safe} double")
                lines.extend(" ".join(f"{x:.17g}" for x in row) for row in arr)
            else:
                raise ValueError(
                    f"point_data[{name!r}] must have 1-3 columns; got {arr.shape[1]}"
                )

    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    return path
