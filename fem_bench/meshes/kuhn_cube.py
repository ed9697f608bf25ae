"""The unit cube cut into n^3 cubes of 6 tetrahedra (Kuhn's split).

Made here in NumPy from ``spec["n"]``: (n+1)^3 vertices on the grid, vertex
(i, j, k) numbered (i (n+1) + j) (n+1) + k, and in every cube the 6
tetrahedra 0 -> e_a -> e_a + e_b -> (1, 1, 1) of the axis permutations
(a, b, c), each positively oriented. The program derives the boundary from
the tetrahedra; the reference from the coordinates.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

PERMUTATIONS = ((0, 1, 2), (1, 2, 0), (2, 0, 1), (0, 2, 1), (2, 1, 0), (1, 0, 2))


def kuhn_cube(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(vertices (n+1)^3 x 3 float64, tetrahedra 6 n^3 x 4 int64)."""
    g = np.linspace(0.0, 1.0, n + 1)
    vertices = np.stack(np.meshgrid(g, g, g, indexing="ij"), axis=-1).reshape(-1, 3)
    i, j, k = (a.reshape(-1) for a in np.meshgrid(*(np.arange(n),) * 3, indexing="ij"))
    stride = np.array([(n + 1) ** 2, n + 1, 1])
    base = i * stride[0] + j * stride[1] + k * stride[2]
    tets = []
    for sign, perm in zip((1, 1, 1, -1, -1, -1), PERMUTATIONS):
        a, b, _ = perm
        path = [0, stride[a], stride[a] + stride[b], int(stride.sum())]
        if sign < 0:  # an odd permutation: swap two vertices to keep det > 0
            path[1], path[2] = path[2], path[1]
        tets.append(base[:, None] + np.array(path)[None, :])
    return vertices, np.concatenate(tets).astype(np.int64)


def inputs(spec: dict, root: Path) -> dict:
    vertices, tets = kuhn_cube(int(spec["n"]))
    return {"vertices": vertices, "tetrahedra": tets}


def port_basis(inp: dict, element: dict, device, dtype):
    from pytorch_fem_solver_tpu_torch import Basis, ElementTet, MeshTet

    mesh = MeshTet({"vertices": inp["vertices"], "tetrahedra": inp["tetrahedra"]},
                   device=device, dtype=dtype)
    return Basis(mesh, ElementTet(element["order"], element["quadrature_degree"]))


def port_vertex_dofs(basis) -> np.ndarray:
    """A P1 basis on a single mesh numbers its DOFs as the mesh's vertices."""
    return np.arange(int(basis.n_dofs), dtype=np.int64)
