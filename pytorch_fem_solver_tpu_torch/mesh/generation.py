"""Host-side triangulation generators (NumPy).

Counterpart of ``pytorch_fem_solver_tpu/mesh/generation.py``: structured
rectangle meshes (right-diagonal, alternating, criss-cross), the unit
square, uniform red refinement and the largest-area diagnostic in 2D; the
structured box (Kuhn subdivision), the unit cube, the Fichera corner and
uniform red refinement of tetrahedra in 3D. Every function returns the
``{"vertices", "triangles" | "tetrahedra", "vertex_markers"}`` dict that
``MeshTri`` / ``MeshTet`` ingest, byte-identical to the JAX package's.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "rectangle",
    "unit_square",
    "refine_uniform",
    "refine_uniform_tet",
    "triangulation_max_area",
    "box",
    "unit_cube",
    "fichera_corner",
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


def refine_uniform_tet(triangulation: dict, times: int = 1) -> dict:
    """Red refinement in 3D: split every tet into 8 via edge midpoints.

    4 corner tets + the central octahedron cut into 4 tets along its
    SHORTEST diagonal. The geometric (label-invariant) diagonal choice is
    what makes repeated refinement stable: measured over 5 levels on random
    tets, the worst min/max-edge aspect settles after at most one level and
    then stays constant (fixed-label diagonals combined with
    orientation-fixing relabels degenerate, 0.41 -> 0.33 -> 0.24 per
    level). Faces are split into the same 4 triangles regardless of which
    adjacent tet produced them (the split uses only the face's own edge
    midpoints), so conformity is preserved; the diagonal choice only
    affects the interior. Children are orientation-fixed to det J > 0.
    Midpoint markers propagate: a midpoint is boundary iff its parent edge
    lies on a boundary face. 3D counterpart of :func:`refine_uniform`; no
    reference-library equivalent (2D-only).
    """
    from .topology import (
        TET_EDGE_PERMUTATIONS,
        _sort_unique_codes,
        encode_edge_pairs,
    )

    out = dict(triangulation)
    for key in ("cells", "tets"):
        if "tetrahedra" not in out and key in out:
            out["tetrahedra"] = out[key]
    for _ in range(times):
        vertices = np.asarray(out["vertices"], dtype=np.float64)
        tets = np.asarray(out["tetrahedra"], dtype=np.int64)
        if "vertex_markers" in out and out["vertex_markers"] is not None:
            markers = np.asarray(out["vertex_markers"]).reshape(-1, 1)
        else:
            from .topology import build_tet_topology

            markers = build_tet_topology(vertices, tets)["vertex_markers"]

        n_v = vertices.shape[0]
        local = tets[:, TET_EDGE_PERMUTATIONS]  # (T, 6, 2)
        flat_codes = encode_edge_pairs(
            np.sort(local.reshape(-1, 2), axis=1), n_v
        )
        # scalar-code dedup rides the native radix tier (same routing as
        # build_tet_topology; np.unique(axis=0) lexsorts cost minutes at
        # refinement scale)
        _, edge_codes, inverse, _ = _sort_unique_codes(flat_codes)

        # a midpoint is boundary iff its edge lies on a boundary face
        # (overflow-guarded dedup; the scalar face code wraps above
        # n_v^3 ~ 2^62)
        from .topology import tet_boundary_faces

        bf = tet_boundary_faces(tets, n_v)
        bf_edges = np.sort(bf[:, [[0, 1], [1, 2], [0, 2]]].reshape(-1, 2), axis=1)
        bf_codes = np.unique(encode_edge_pairs(bf_edges, n_v))
        mid_markers = (
            np.isin(edge_codes, bf_codes).astype(np.int64).reshape(-1, 1)
        )
        edges = np.stack(np.divmod(edge_codes, n_v), axis=1)

        midpoints = vertices[edges].mean(axis=1)
        mid_ids = n_v + np.arange(edges.shape[0])

        # edge ids per tet in local order (01, 12, 02, 03, 13, 23)
        e = inverse.reshape(-1, 6)
        m01, m12, m02, m03, m13, m23 = (mid_ids[e[:, k]] for k in range(6))
        v0, v1, v2, v3 = tets[:, 0], tets[:, 1], tets[:, 2], tets[:, 3]

        new_vertices = np.concatenate([vertices, midpoints], axis=0)

        corner = np.stack(
            [
                np.stack([v0, m01, m02, m03], axis=1),
                np.stack([m01, v1, m12, m13], axis=1),
                np.stack([m02, m12, v2, m23], axis=1),
                np.stack([m03, m13, m23, v3], axis=1),
            ],
            axis=1,
        )

        # central octahedron: pick the shortest of its 3 diagonals per tet,
        # then form 4 tets from that diagonal + the 4 equatorial edges
        d1 = np.linalg.norm(new_vertices[m01] - new_vertices[m23], axis=1)
        d2 = np.linalg.norm(new_vertices[m02] - new_vertices[m13], axis=1)
        d3 = np.linalg.norm(new_vertices[m03] - new_vertices[m12], axis=1)
        choice = np.argmin(np.stack([d1, d2, d3], axis=1), axis=1)

        def octa(a, b, ring):
            return np.stack(
                [
                    np.stack([a, b, ring[k], ring[(k + 1) % 4]], axis=1)
                    for k in range(4)
                ],
                axis=1,
            )

        int_sets = [
            octa(m01, m23, (m02, m03, m13, m12)),
            octa(m02, m13, (m01, m03, m23, m12)),
            octa(m03, m12, (m01, m02, m23, m13)),
        ]
        interior = np.where(
            (choice == 0)[:, None, None],
            int_sets[0],
            np.where((choice == 1)[:, None, None], int_sets[1], int_sets[2]),
        )
        children = np.concatenate([corner, interior], axis=1).reshape(-1, 4)
        p = new_vertices[children]
        det = np.linalg.det((p[:, 1:] - p[:, [0]]).transpose(0, 2, 1))
        neg = det < 0
        children[neg] = children[neg][:, [0, 2, 1, 3]]

        out = {
            "vertices": new_vertices,
            "tetrahedra": children,
            "vertex_markers": np.concatenate([markers, mid_markers], axis=0),
        }
    return out


def box(
    nx: int,
    ny: int,
    nz: int,
    x0: float = 0.0,
    x1: float = 1.0,
    y0: float = 0.0,
    y1: float = 1.0,
    z0: float = 0.0,
    z1: float = 1.0,
) -> dict:
    """Structured tetrahedralization of a box with nx*ny*nz cubes.

    Each cube is split into 6 tetrahedra along its main diagonal
    (Freudenthal/Kuhn subdivision): one tet per permutation pi of the axes,
    with vertices (0, e_{pi0}, e_{pi0}+e_{pi1}, (1,1,1)). Every cube uses the
    same diagonal, so shared faces match across cubes and the mesh is
    conforming. All tets are emitted positively oriented (det J > 0).

    3D counterpart of :func:`rectangle`; the reference library (2D-only,
    ``triangle``-based) has no equivalent.
    """
    if nx < 1 or ny < 1 or nz < 1:
        raise ValueError("nx, ny and nz must be >= 1")

    xs = np.linspace(x0, x1, nx + 1)
    ys = np.linspace(y0, y1, ny + 1)
    zs = np.linspace(z0, z1, nz + 1)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    vertices = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def vid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    i, j, k = np.meshgrid(
        np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij"
    )
    i, j, k = i.ravel(), j.ravel(), k.ravel()

    # the 6 axis permutations; each path 0 -> e_a -> e_a+e_b -> (1,1,1)
    perms = [(0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)]
    eye = np.eye(3, dtype=np.int64)
    tets = []
    for a, b, c in perms:
        o1 = eye[a]
        o2 = eye[a] + eye[b]
        corners = [
            (0, 0, 0),
            tuple(o1),
            tuple(o2),
            (1, 1, 1),
        ]
        tet = np.stack(
            [vid(i + di, j + dj, k + dk) for (di, dj, dk) in corners], axis=1
        )
        tets.append(tet)
    tetrahedra = np.concatenate(tets, axis=0)

    # enforce positive orientation (odd permutations produce det < 0)
    p = vertices[tetrahedra]
    det = np.linalg.det((p[:, 1:] - p[:, [0]]).transpose(0, 2, 1))
    neg = det < 0
    tetrahedra[neg] = tetrahedra[neg][:, [0, 2, 1, 3]]

    markers = np.zeros((vertices.shape[0], 1), dtype=np.int64)
    coords = vertices
    eps = 1e-12
    edge = (
        (np.abs(coords[:, 0] - x0) < eps)
        | (np.abs(coords[:, 0] - x1) < eps)
        | (np.abs(coords[:, 1] - y0) < eps)
        | (np.abs(coords[:, 1] - y1) < eps)
        | (np.abs(coords[:, 2] - z0) < eps)
        | (np.abs(coords[:, 2] - z1) < eps)
    )
    markers[edge] = 1

    return {
        "vertices": vertices,
        "tetrahedra": tetrahedra,
        "vertex_markers": markers,
    }


def unit_cube(n: int) -> dict:
    """Unit-cube tet mesh with n^3 cubes (6 n^3 tetrahedra), h = sqrt(3)/n."""
    return box(n, n, n)


def fichera_corner(n: int) -> dict:
    """Fichera-corner tet mesh: (-1, 1)^3 minus the closed octant [0, 1]^3.

    Built from a structured ``box`` of (2n)^3 cubes by dropping every tet
    whose centroid lies in the removed octant; the Kuhn subdivision keeps
    all tets inside their cube, and the octant boundary aligns with cube
    faces, so the remaining mesh is conforming. Vertex markers are
    recomputed from the actual boundary faces (faces with a single incident
    tet), which marks the re-entrant faces too. The re-entrant edge at the
    origin caps the solution regularity (u in H^{s}, s < 5/3 generically),
    making this the canonical 3D adaptivity benchmark; the reference has no
    3D meshing at all (2D ``triangle`` only).
    """
    if n < 1:
        raise ValueError("n must be >= 1")
    full = box(2 * n, 2 * n, 2 * n, -1.0, 1.0, -1.0, 1.0, -1.0, 1.0)
    vertices = full["vertices"]
    tets = full["tetrahedra"]
    centroids = vertices[tets].mean(axis=1)
    keep = ~(centroids > 0.0).all(axis=1)
    tets = tets[keep]

    used = np.zeros(vertices.shape[0], dtype=bool)
    used[tets.ravel()] = True
    remap = np.cumsum(used) - 1
    vertices = vertices[used]
    tets = remap[tets]

    from .topology import build_tet_topology

    markers = np.asarray(
        build_tet_topology(vertices, tets)["vertex_markers"]
    ).reshape(-1, 1)
    return {
        "vertices": vertices,
        "tetrahedra": tets,
        "vertex_markers": markers,
    }
