"""Host-side triangulation generators (NumPy), 2D half.

Counterpart of ``pytorch_fem_solver_tpu/mesh/generation.py``: structured
rectangle meshes (right-diagonal, alternating, criss-cross), the unit
square, uniform red refinement and the largest-area diagnostic. Every
function returns the ``{"vertices", "triangles", "vertex_markers"}`` dict
that ``MeshTri`` ingests, byte-identical to the JAX package's. The tet half
(``refine_uniform_tet``, ``box``, ``unit_cube``, ``fichera_corner``) is
queued in ROADMAP.md (A12).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rectangle",
    "unit_square",
    "refine_uniform",
    "triangulation_max_area",
]


def _mark_boundary_vertices(vertices: np.ndarray, triangles: np.ndarray) -> np.ndarray:
    """Vertex markers: 1 on the mesh boundary, 0 in the interior."""
    local = triangles[:, [[0, 1], [1, 2], [0, 2]]].reshape(-1, 2)
    local = np.sort(local, axis=1)
    edges, counts = np.unique(local, axis=0, return_counts=True)
    boundary_vertices = np.unique(edges[counts == 1])
    markers = np.zeros((vertices.shape[0], 1), dtype=np.int64)
    markers[boundary_vertices] = 1
    return markers


def rectangle(
    nx: int,
    ny: int,
    x0: float = 0.0,
    x1: float = 1.0,
    y0: float = 0.0,
    y1: float = 1.0,
    pattern: str = "alternating",
) -> dict:
    """Structured triangulation of [x0,x1] x [y0,y1] with nx*ny quads.

    pattern:
      * "right": every quad split along the same diagonal,
      * "alternating": union-jack diagonals (better isotropy),
      * "crisscross": each quad split into 4 triangles around its center.
    """
    if nx < 1 or ny < 1:
        raise ValueError("nx and ny must be >= 1")

    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="xy")
    vertices = np.stack([gx.ravel(), gy.ravel()], axis=-1)

    def vid(i, j):
        return j * (nx + 1) + i

    tris = []
    if pattern == "crisscross":
        centers = []
        n_grid = vertices.shape[0]
        for j in range(ny):
            for i in range(nx):
                cidx = n_grid + len(centers)
                centers.append(
                    [(xs[i] + xs[i + 1]) * 0.5, (ys[j] + ys[j + 1]) * 0.5]
                )
                a, b = vid(i, j), vid(i + 1, j)
                c, d = vid(i + 1, j + 1), vid(i, j + 1)
                tris += [[a, b, cidx], [b, c, cidx], [c, d, cidx], [d, a, cidx]]
        vertices = np.concatenate([vertices, np.asarray(centers)], axis=0)
    else:
        for j in range(ny):
            for i in range(nx):
                a, b = vid(i, j), vid(i + 1, j)
                c, d = vid(i + 1, j + 1), vid(i, j + 1)
                flip = pattern == "alternating" and (i + j) % 2 == 1
                if flip:
                    tris += [[a, b, c], [a, c, d]]
                else:
                    tris += [[a, b, d], [b, c, d]]

    triangles = np.asarray(tris, dtype=np.int64)
    vertices = np.asarray(vertices, dtype=np.float64)

    return {
        "vertices": vertices,
        "triangles": triangles,
        "vertex_markers": _mark_boundary_vertices(vertices, triangles),
    }


def unit_square(max_area: float | None = None, n: int | None = None) -> dict:
    """Unit-square mesh with per-triangle area <= max_area (or n x n quads)."""
    if n is None:
        if max_area is None:
            raise ValueError("provide max_area or n")
        n = max(1, int(np.ceil(1.0 / np.sqrt(2.0 * max_area))))
    return rectangle(n, n)


def refine_uniform(triangulation: dict, times: int = 1) -> dict:
    """Red refinement: split every triangle into 4 via edge midpoints.

    Vertex markers propagate: a midpoint is boundary iff its parent edge is a
    boundary edge (shared by exactly one triangle).
    """
    out = triangulation
    for _ in range(times):
        vertices = np.asarray(out["vertices"], dtype=np.float64)
        triangles = np.asarray(out["triangles"], dtype=np.int64)
        markers = np.asarray(
            out.get("vertex_markers", _mark_boundary_vertices(vertices, triangles))
        ).reshape(-1, 1)

        local = triangles[:, [[0, 1], [1, 2], [0, 2]]]
        flat = np.sort(local.reshape(-1, 2), axis=1)
        edges, inverse, counts = np.unique(
            flat, axis=0, return_inverse=True, return_counts=True
        )

        midpoints = vertices[edges].mean(axis=1)
        mid_ids = vertices.shape[0] + np.arange(edges.shape[0])
        mid_markers = (counts == 1).astype(np.int64).reshape(-1, 1)

        # edge ids per triangle in local order (01, 12, 02)
        e = inverse.reshape(-1, 3)
        m01, m12, m02 = (mid_ids[e[:, 0]], mid_ids[e[:, 1]], mid_ids[e[:, 2]])
        v0, v1, v2 = triangles[:, 0], triangles[:, 1], triangles[:, 2]

        children = np.stack(
            [
                np.stack([v0, m01, m02], axis=1),
                np.stack([m01, v1, m12], axis=1),
                np.stack([m02, m12, v2], axis=1),
                np.stack([m01, m12, m02], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)

        out = {
            "vertices": np.concatenate([vertices, midpoints], axis=0),
            "triangles": children,
            "vertex_markers": np.concatenate([markers, mid_markers], axis=0),
        }
    return out


def triangulation_max_area(triangulation: dict) -> float:
    """Largest triangle area in the mesh (host-side diagnostic)."""
    v = np.asarray(triangulation["vertices"])
    t = np.asarray(triangulation["triangles"])
    p = v[t]
    d1 = p[:, 1] - p[:, 0]
    d2 = p[:, 2] - p[:, 0]
    areas = 0.5 * np.abs(d1[:, 0] * d2[:, 1] - d1[:, 1] * d2[:, 0])
    return float(areas.max())
