"""Host-side derived mesh topology (NumPy, construction time only).

Computes what the reference derives inside ``AbstractMesh`` at construction
(reference torch_fem/mesh/abstract_mesh.py:76-255): unique edges,
interior/boundary split, adjacent cells per edge, interior-edge normals with
centroid-based orientation, and per-cell minimum edge length. Unlike the
reference (which keeps ``torch.unique`` *counts* as edge "markers" and has an
O(E*T) broadcast fallback for cell adjacency), this implementation always
derives adjacency in O(E) from the unique-edge inverse index and stores
explicit boundary markers.

All outputs are static-shape NumPy arrays; the device boundary starts after mesh
construction.
"""

from __future__ import annotations

import numpy as np

#: local vertex pairs forming the 3 edges of a triangle, matching the
#: reference convention (mesh_tri.py:10-12)
TRI_EDGE_PERMUTATIONS = np.array([[0, 1], [1, 2], [0, 2]], dtype=np.int64)


def build_tri_topology(
    vertices: np.ndarray,
    triangles: np.ndarray,
    vertex_markers: np.ndarray | None = None,
) -> dict:
    """Derive full edge topology for a 2D triangle mesh.

    Returns a dict of NumPy arrays:
      edges_vertices (E,2), edges_markers (E,1)  [1 = boundary],
      interior_edges_vertices (Ei,2), interior_edges_cells (Ei,2),
      boundary_edges_vertices (Eb,2), boundary_edges_cells (Eb,1),
      interior_edges_length (Ei,1,1), interior_edges_normals (Ei,1,2),
      cells_min_length (T,1,1), vertex_markers (n,1).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    triangles = np.asarray(triangles, dtype=np.int64)

    local_edges = triangles[:, TRI_EDGE_PERMUTATIONS]  # (T, 3, 2)

    from ..native import unique_edges as native_unique_edges

    native_result = native_unique_edges(triangles, vertices.shape[0])
    if native_result is not None:
        # single-pass C++ radix dedup (native/src/fem_native.cpp); output is
        # byte-identical to the NumPy path below (tests/test_native.py)
        edges, inverse, counts, order = native_result
    else:
        flat = np.sort(local_edges.reshape(-1, 2), axis=1)  # (3T, 2)
        edges, inverse, counts = np.unique(
            flat, axis=0, return_inverse=True, return_counts=True
        )
        if counts.max(initial=0) > 2:
            raise ValueError(
                "non-manifold mesh: an edge is shared by >2 triangles"
            )
        # adjacency: positions of each unique edge in the flattened
        # (cell, local) list, grouped via a stable argsort of the inverse
        order = np.argsort(inverse, kind="stable")
    n_edges = edges.shape[0]
    cells_of_occurrence = order // 3  # flattened position -> owning cell
    offsets = np.concatenate([[0], np.cumsum(counts)])

    interior_mask = counts == 2
    boundary_mask = counts == 1

    interior_ids = np.nonzero(interior_mask)[0]
    boundary_ids = np.nonzero(boundary_mask)[0]

    # for interior edges the two occurrences are consecutive in `order`
    starts = offsets[interior_ids]
    interior_cells = np.stack(
        [cells_of_occurrence[starts], cells_of_occurrence[starts + 1]], axis=1
    )
    interior_cells = np.sort(interior_cells, axis=1)
    boundary_cells = cells_of_occurrence[offsets[boundary_ids]].reshape(-1, 1)

    interior_edges_vertices = edges[interior_ids]
    boundary_edges_vertices = edges[boundary_ids]

    edges_markers = boundary_mask.astype(np.int64).reshape(-1, 1)

    if vertex_markers is None:
        vertex_markers = np.zeros((vertices.shape[0], 1), dtype=np.int64)
        vertex_markers[np.unique(boundary_edges_vertices)] = 1
    else:
        vertex_markers = np.asarray(vertex_markers, dtype=np.int64).reshape(-1, 1)

    # interior edge geometry: lengths + normals oriented from the first
    # adjacent cell toward the second (the reference fixes orientation with
    # the same centroid test, abstract_mesh.py:143-162)
    p = vertices[interior_edges_vertices]  # (Ei, 2, 2)
    vec = p[:, 1] - p[:, 0]
    length = np.linalg.norm(vec, axis=-1, keepdims=True)  # (Ei, 1)
    normal = np.stack([-vec[:, 1], vec[:, 0]], axis=-1) / length

    centroids = vertices[triangles].mean(axis=1)  # (T, 2)
    c1 = centroids[interior_cells[:, 0]]
    c2 = centroids[interior_cells[:, 1]]
    flip = ((c2 - c1) * normal).sum(axis=-1) < 0
    normal[flip] *= -1.0

    # per-cell minimum edge length (mesh-size indicator h_T)
    cell_edge_coords = vertices[local_edges]  # (T, 3, 2, 2)
    cell_edge_len = np.linalg.norm(
        cell_edge_coords[:, :, 1] - cell_edge_coords[:, :, 0], axis=-1
    )
    # (T, 1, 1, 1): includes the quadrature broadcast axis so that forms like
    # h_T**2 * integrand(T, q, 1, 1) broadcast directly (the reference stores
    # (T, 1, 1), which cannot broadcast against per-quadrature integrands)
    cells_min_length = cell_edge_len.min(axis=1).reshape(-1, 1, 1, 1)

    assert n_edges == interior_ids.size + boundary_ids.size

    return {
        "edges_vertices": edges,
        "edges_markers": edges_markers,
        "interior_edges_vertices": interior_edges_vertices,
        "interior_edges_cells": interior_cells,
        "boundary_edges_vertices": boundary_edges_vertices,
        "boundary_edges_cells": boundary_cells,
        "interior_edges_length": length.reshape(-1, 1, 1),
        "interior_edges_normals": normal.reshape(-1, 1, 2),
        "cells_min_length": cells_min_length,
        "vertex_markers": vertex_markers,
    }


#: local vertex pairs forming the 6 edges of a tetrahedron; the first three
#: extend the triangle convention, the last three are the apex edges. Must
#: match the P2 shape-function layout in ``element_tet.py``.
TET_EDGE_PERMUTATIONS = np.array(
    [[0, 1], [1, 2], [0, 2], [0, 3], [1, 3], [2, 3]], dtype=np.int64
)

#: local vertex triples forming the 4 faces of a tetrahedron (face i is
#: opposite vertex 3-i under this ordering's complement; orientation is not
#: meaningful here — faces are stored vertex-sorted)
TET_FACE_PERMUTATIONS = np.array(
    [[0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]], dtype=np.int64
)


def build_tet_topology(
    vertices: np.ndarray,
    tetrahedra: np.ndarray,
    vertex_markers: np.ndarray | None = None,
) -> dict:
    """Derive face + edge topology for a 3D tetrahedral mesh.

    3D counterpart of :func:`build_tri_topology` (the reference library is
    2D-only). Faces play the role edges play in 2D: the interior/boundary
    split, adjacent cells and oriented normals all live on the unique faces;
    unique *edges* are additionally derived because P2 DOFs sit on them.

    Returns a dict of NumPy arrays:
      faces_vertices (F,3), faces_markers (F,1)  [1 = boundary],
      interior_faces_vertices (Fi,3), interior_faces_cells (Fi,2),
      boundary_faces_vertices (Fb,3), boundary_faces_cells (Fb,1),
      interior_faces_area (Fi,1,1), interior_faces_normals (Fi,1,3),
      edges_vertices (E,2), edges_markers (E,1)  [1 = on a boundary face],
      cells_min_length (T,1,1,1), vertex_markers (n,1).
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    tets = np.asarray(tetrahedra, dtype=np.int64)

    n_vertices = vertices.shape[0]
    edge_codes_all = None
    if n_vertices**3 < 2**62:
        # dedup over scalar int64 face codes: 1D unique beats the
        # lexsort-backed axis=0 path; the native tier emits the sorted
        # codes in one streaming pass (inline sorting networks) and
        # radix-dedups them (native/fem_tet_face_edge_keys + sort_unique)
        from ..native import tet_face_edge_keys

        keys = tet_face_edge_keys(tets, n_vertices)
        if keys is not None:
            codes, edge_codes_all = keys
        else:
            flat = np.sort(
                tets[:, TET_FACE_PERMUTATIONS].reshape(-1, 3), axis=1
            )
            codes = (
                flat[:, 0] * n_vertices + flat[:, 1]
            ) * n_vertices + flat[:, 2]
        order, uniq_codes, inverse, counts = _sort_unique_codes(codes)
        ab, c = np.divmod(uniq_codes, n_vertices)
        a, b = np.divmod(ab, n_vertices)
        faces = np.stack([a, b, c], axis=1)
    else:  # pragma: no cover - >2M-vertex meshes overflow the code space
        flat = np.sort(tets[:, TET_FACE_PERMUTATIONS].reshape(-1, 3), axis=1)
        faces, inverse, counts = np.unique(
            flat, axis=0, return_inverse=True, return_counts=True
        )
        inverse = inverse.reshape(-1)
        order = np.argsort(inverse, kind="stable")
    if counts.max(initial=0) > 2:
        raise ValueError("non-manifold mesh: a face is shared by >2 tetrahedra")
    cells_of_occurrence = order // 4
    offsets = np.concatenate([[0], np.cumsum(counts)])

    interior_ids = np.nonzero(counts == 2)[0]
    boundary_ids = np.nonzero(counts == 1)[0]

    starts = offsets[interior_ids]
    interior_cells = np.sort(
        np.stack(
            [cells_of_occurrence[starts], cells_of_occurrence[starts + 1]],
            axis=1,
        ),
        axis=1,
    )
    boundary_cells = cells_of_occurrence[offsets[boundary_ids]].reshape(-1, 1)

    interior_faces_vertices = faces[interior_ids]
    boundary_faces_vertices = faces[boundary_ids]
    faces_markers = (counts == 1).astype(np.int64).reshape(-1, 1)

    if vertex_markers is None:
        vertex_markers = np.zeros((vertices.shape[0], 1), dtype=np.int64)
        vertex_markers[np.unique(boundary_faces_vertices)] = 1
    else:
        vertex_markers = np.asarray(vertex_markers, dtype=np.int64).reshape(-1, 1)

    # interior face geometry: areas + unit normals oriented from the first
    # adjacent cell toward the second (same centroid test as 2D)
    p = vertices[interior_faces_vertices]  # (Fi, 3, 3)
    cross = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    doubled = np.linalg.norm(cross, axis=-1, keepdims=True)
    area = 0.5 * doubled
    normal = cross / np.maximum(doubled, 1e-300)

    centroids = vertices[tets].mean(axis=1)  # (T, 3)
    c1 = centroids[interior_cells[:, 0]]
    c2 = centroids[interior_cells[:, 1]]
    flip = ((c2 - c1) * normal).sum(axis=-1) < 0
    normal[flip] *= -1.0

    # unique edges (P2 DOF sites); an edge is boundary iff it lies on a
    # boundary face
    if edge_codes_all is None:
        local_edges = tets[:, TET_EDGE_PERMUTATIONS].reshape(-1, 2)
        edge_codes_all = encode_edge_pairs(
            np.sort(local_edges, axis=1), n_vertices
        )
    _, edge_codes, _, _ = _sort_unique_codes(edge_codes_all)
    ea, eb = np.divmod(edge_codes, n_vertices)
    edges = np.stack([ea, eb], axis=1)
    bf = boundary_faces_vertices
    bf_edges = np.sort(
        bf[:, [[0, 1], [1, 2], [0, 2]]].reshape(-1, 2), axis=1
    )
    boundary_edge_codes = np.unique(encode_edge_pairs(bf_edges, n_vertices))
    edges_markers = (
        np.isin(edge_codes, boundary_edge_codes).astype(np.int64).reshape(-1, 1)
    )

    cell_edge_coords = vertices[tets[:, TET_EDGE_PERMUTATIONS]]  # (T, 6, 2, 3)
    cell_edge_len = np.linalg.norm(
        cell_edge_coords[:, :, 1] - cell_edge_coords[:, :, 0], axis=-1
    )
    cells_min_length = cell_edge_len.min(axis=1).reshape(-1, 1, 1, 1)

    return {
        "faces_vertices": faces,
        "faces_markers": faces_markers,
        "interior_faces_vertices": interior_faces_vertices,
        "interior_faces_cells": interior_cells,
        "boundary_faces_vertices": boundary_faces_vertices,
        "boundary_faces_cells": boundary_cells,
        "interior_faces_area": area.reshape(-1, 1, 1),
        "interior_faces_normals": normal.reshape(-1, 1, 3),
        "edges_vertices": edges,
        "edges_markers": edges_markers,
        "cells_min_length": cells_min_length,
        "vertex_markers": vertex_markers,
    }


def p2_cell_edge_pairs(cells: np.ndarray) -> np.ndarray:
    """``(T, n_edges, 2)`` sorted vertex pairs of each cell's local edges.

    Local edge order matches the P2 shape-function layout: (01, 12, 02) for
    triangles (``element_tri.py``: midpoint functions 4*l1*l2, 4*l2*l3,
    4*l3*l1) and (01, 12, 02, 03, 13, 23) for tetrahedra
    (``element_tet.py``). Shared by every P2 DOF builder (plain, DFN-batched,
    DFN-flat, 3D) so the edge-identification logic exists exactly once.
    """
    cells = np.asarray(cells)
    if cells.shape[-1] == 4:
        return np.sort(cells[:, TET_EDGE_PERMUTATIONS], axis=-1)
    return np.sort(cells[:, [[0, 1], [1, 2], [0, 2]]], axis=-1)


def _sort_unique_codes(codes: np.ndarray):
    """(order, unique, inverse, counts) of int64 codes.

    Routed through the native single-pass radix tier when available
    (``native.sort_unique``), byte-identical NumPy fallback otherwise; both
    match ``np.unique(codes, return_inverse=True, return_counts=True)``
    plus the stable ascending argsort.
    """
    from ..native import sort_unique

    result = sort_unique(codes)
    if result is not None:
        return result
    uniq, inverse, counts = np.unique(
        codes, return_inverse=True, return_counts=True
    )
    order = np.argsort(codes, kind="stable")
    return order, uniq, inverse.reshape(-1), counts


def tet_boundary_faces(tets, n_vertices: int) -> np.ndarray:
    """Vertex triples (sorted) of faces with a single incident tet.

    Overflow-safe: the scalar int64 face encoding (a*n + b)*n + c needs
    n_vertices^3 < 2^62 (the same guard ``build_tet_topology`` uses); above
    that it falls back to ``np.unique(axis=0)`` row dedup instead of
    silently wrapping and misclassifying boundary faces.
    """
    tets = np.asarray(tets, dtype=np.int64)
    flat = np.sort(tets[:, TET_FACE_PERMUTATIONS].reshape(-1, 3), axis=1)
    if n_vertices**3 < 2**62:
        codes = (
            flat[:, 0] * n_vertices + flat[:, 1]
        ) * n_vertices + flat[:, 2]
        _, uniq_codes, _, counts = _sort_unique_codes(codes)
        ab, c = np.divmod(uniq_codes[counts == 1], n_vertices)
        a, b = np.divmod(ab, n_vertices)
        return np.stack([a, b, c], axis=1)
    uniq, counts = np.unique(flat, axis=0, return_counts=True)
    return uniq[counts == 1]


def unique_edge_ids(cells, edges, n_vertices: int) -> np.ndarray:
    """Per-cell local-edge -> unique-edge-id table.

    ``cells`` (T, k) index into the mesh's unique ``edges`` (E, 2) table;
    local edge order is :func:`p2_cell_edge_pairs`'s. Shared by the P2 and
    P3 DOF builders so the encode/argsort/searchsorted lookup exists once.
    """
    local_codes = encode_edge_pairs(p2_cell_edge_pairs(cells), n_vertices)
    edge_codes = encode_edge_pairs(
        np.sort(np.asarray(edges), axis=-1), n_vertices
    )
    order = np.argsort(edge_codes)
    return order[np.searchsorted(edge_codes[order], local_codes)]


def p2_edge_dirichlet_markers(edges, edge_markers, vertex_markers):
    """Dirichlet flags for P2 edge-midpoint DOFs.

    A midpoint is constrained iff its edge lies on the boundary (2D: a
    single incident cell; 3D: on a boundary face) AND both endpoints carry
    nonzero vertex markers — so partial markers (mixed BCs: only the
    Dirichlet portion marked) leave Neumann-edge midpoints free instead of
    silently pinning them to the lift value. The label is the stronger
    endpoint label. With full boundary markers this reduces to the plain
    boundary mask.
    """
    edges = np.asarray(edges)
    em = np.asarray(edge_markers).reshape(-1)
    vm = np.asarray(vertex_markers).reshape(-1)
    m0, m1 = vm[edges[:, 0]], vm[edges[:, 1]]
    both = (m0 != 0) & (m1 != 0) & (em != 0)
    return np.where(both, np.maximum(m0, m1), 0).astype(np.int64)


def encode_edge_pairs(pairs: np.ndarray, n_vertices: int) -> np.ndarray:
    """Scalar int64 code per (sorted) vertex pair: ``v0 * n_vertices + v1``.

    Always widens to int64 before the multiply: index tables default to
    int32 (``config.index_dtype``) and ``v0 * n_vertices`` silently wraps
    past ~46k vertices under NumPy 2.x promotion rules.
    """
    p = np.asarray(pairs)
    return p[..., 0].astype(np.int64) * int(n_vertices) + p[..., 1]
