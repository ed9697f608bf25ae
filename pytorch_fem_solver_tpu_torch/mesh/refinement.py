"""Adaptive local mesh refinement: longest-edge (Rivara) bisection.

Counterpart of ``pytorch_fem_solver_tpu/mesh/refinement.py``, the triangle
half (the tetrahedral ``refine_adaptive_tet`` waits for the tet meshes,
ROADMAP.md queue A item 6). Dörfler marking picks the cells; every marked
triangle bisects its longest edge, and a closure pass keeps the mesh
conforming (an edge being split forces both adjacent triangles to split
it). ``refine_network_adaptive`` extends the loop to fracture networks: the
per-fracture closures exchange marks on shared (trace) edges, keyed by
their glued global vertex pairs, until the whole network is stable, so a
trace edge bisects consistently in every incident fracture.

Everything runs on host NumPy at mesh-build time and is the JAX package's
code line for line (the sorts, ``np.unique`` and ``np.logical_or.at``
included), so the refined triangulations are byte-identical and number
their DOFs alike. Tensors passed in (the indicators, the marks, a mesh's
global ids) are read back to the host first.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "refine_adaptive",
    "refine_network_adaptive",
    "dorfler_mark",
]


def _host(array) -> np.ndarray:
    """A host NumPy view of a tensor (any device) or array-like."""
    if isinstance(array, torch.Tensor):
        return array.detach().cpu().numpy()
    return np.asarray(array)


def dorfler_mark(indicators, theta: float = 0.5) -> np.ndarray:
    """Dörfler (bulk-chasing) marking: smallest set holding theta of the
    total squared indicator. Returns a boolean (T,) mask."""
    eta2 = _host(indicators).astype(np.float64).reshape(-1) ** 2
    order = np.argsort(eta2)[::-1]
    csum = np.cumsum(eta2[order])
    count = int(np.searchsorted(csum, theta * csum[-1])) + 1
    marked = np.zeros(eta2.size, dtype=bool)
    marked[order[:count]] = True
    return marked


class _EdgeTables:
    """Unique edges, per-triangle edge ids (cycle order), longest edges."""

    def __init__(self, vertices, triangles):
        local = triangles[:, [[0, 1], [1, 2], [2, 0]]]  # (T, 3, 2)
        flat = np.sort(local.reshape(-1, 2), axis=1)
        self.edges, inverse, self.counts = np.unique(
            flat, axis=0, return_inverse=True, return_counts=True
        )
        self.e_ids = inverse.reshape(-1, 3)
        lens = np.linalg.norm(
            vertices[local[..., 0]] - vertices[local[..., 1]], axis=-1
        )
        self.longest_local = lens.argmax(axis=1)
        self.longest_edge = self.e_ids[
            np.arange(triangles.shape[0]), self.longest_local
        ]


def _closure(tables: _EdgeTables, edge_marked: np.ndarray) -> None:
    """Mark the longest edge of every triangle touching a marked edge,
    iterated to a fixpoint (monotone, so it terminates)."""
    while True:
        touched = edge_marked[tables.e_ids].any(axis=1)
        grow = touched & ~edge_marked[tables.longest_edge]
        if not grow.any():
            break
        edge_marked[tables.longest_edge[grow]] = True


def _bisect(vertices, triangles, markers, tables, edge_marked, edge_labels):
    """Split triangles against a closed edge-mark set.

    Requires the closure invariant: any triangle with a marked edge has its
    longest edge marked. ``edge_labels`` (E,) provides the vertex label for
    each new midpoint (0 for interior edges).
    """
    n_mid = int(edge_marked.sum())
    if n_mid == 0:
        return {
            "vertices": vertices,
            "triangles": triangles,
            "vertex_markers": markers,
        }, np.full(tables.edges.shape[0], -1, dtype=np.int64)

    mid_of_edge = np.full(tables.edges.shape[0], -1, dtype=np.int64)
    mid_of_edge[edge_marked] = vertices.shape[0] + np.arange(n_mid)
    midpoints = vertices[tables.edges[edge_marked]].mean(axis=1)
    mid_markers = edge_labels[edge_marked].reshape(-1, 1)

    # rotate every split triangle so its longest edge is (a, b), apex c —
    # rotations preserve orientation
    rot = np.stack(
        [
            tables.longest_local,
            (tables.longest_local + 1) % 3,
            (tables.longest_local + 2) % 3,
        ],
        axis=1,
    )
    abc = np.take_along_axis(triangles, rot, axis=1)
    a, b, c = abc[:, 0], abc[:, 1], abc[:, 2]
    e_rot = np.take_along_axis(tables.e_ids, rot, axis=1)
    m_ab = mid_of_edge[e_rot[:, 0]]
    bc_m = edge_marked[e_rot[:, 1]]
    ca_m = edge_marked[e_rot[:, 2]]
    m_bc = mid_of_edge[e_rot[:, 1]]
    m_ca = mid_of_edge[e_rot[:, 2]]

    split = edge_marked[tables.longest_edge]
    out = [triangles[~split]]

    def tri(*cols):
        return np.stack(cols, axis=1)

    # first bisection: (a, m, c) and (m, b, c); each half bisects again if
    # its remaining original edge (ca / bc) is marked
    s = split
    left_plain = s & ~ca_m
    left_split = s & ca_m
    right_plain = s & ~bc_m
    right_split = s & bc_m
    out.append(tri(a[left_plain], m_ab[left_plain], c[left_plain]))
    out.append(tri(a[left_split], m_ab[left_split], m_ca[left_split]))
    out.append(tri(m_ab[left_split], c[left_split], m_ca[left_split]))
    out.append(tri(m_ab[right_plain], b[right_plain], c[right_plain]))
    out.append(tri(m_ab[right_split], b[right_split], m_bc[right_split]))
    out.append(tri(m_ab[right_split], m_bc[right_split], c[right_split]))

    refined = {
        "vertices": np.concatenate([vertices, midpoints], axis=0),
        "triangles": np.concatenate([t for t in out if t.size], axis=0),
        "vertex_markers": np.concatenate([markers, mid_markers], axis=0),
    }
    return refined, mid_of_edge


def _load(triangulation, label_key="vertex_markers"):
    vertices = np.asarray(triangulation["vertices"], dtype=np.float64)
    triangles = np.asarray(triangulation["triangles"], dtype=np.int64)
    markers = np.asarray(
        triangulation.get(
            label_key, np.zeros((vertices.shape[0], 1), dtype=np.int64)
        )
    ).reshape(-1, 1)
    return vertices, triangles, markers


def _boundary_edge_labels(tables, markers):
    """Label per edge for new midpoints: boundary edges (one incident cell)
    inherit the stronger endpoint label; interior edges stay 0."""
    ml = markers.reshape(-1)
    ends = np.maximum(ml[tables.edges[:, 0]], ml[tables.edges[:, 1]])
    return np.where(tables.counts == 1, ends, 0).astype(np.int64)


def refine_adaptive(triangulation: dict, marked) -> dict:
    """Bisect marked triangles (longest edge), closure keeps conformity.

    Args:
      triangulation: dict with ``vertices`` (N, d), ``triangles`` (T, 3)
        and optional ``vertex_markers`` (N, 1) (nonzero = boundary).
      marked: (T,) boolean mask of triangles to refine.

    Returns a new triangulation dict of the same shape. Midpoint vertices
    of boundary edges (edges with a single adjacent triangle) inherit the
    stronger endpoint marker.
    """
    vertices, triangles, markers = _load(triangulation)
    marked = _host(marked).astype(bool).reshape(-1)
    if marked.shape[0] != triangles.shape[0]:
        raise ValueError(
            f"marked has {marked.shape[0]} entries for "
            f"{triangles.shape[0]} cells"
        )

    tables = _EdgeTables(vertices, triangles)
    edge_marked = np.zeros(tables.edges.shape[0], dtype=bool)
    edge_marked[tables.longest_edge[marked]] = True
    _closure(tables, edge_marked)
    labels = _boundary_edge_labels(tables, markers)
    refined, _ = _bisect(
        vertices, triangles, markers, tables, edge_marked, labels
    )
    return refined


def refine_network_adaptive(
    triangulations, mesh, marked, label_key: str = "vertex_labels"
):
    """Adaptively refine a fracture network, conforming across traces.

    Args:
      triangulations: the per-fracture 2D dicts the network mesh was built
        from (order must match).
      mesh: the ``FractureNetworkMesh`` built from them (supplies the glued
        global vertex ids that identify shared trace edges).
      marked: boolean mask over the network's flat cell axis.
      label_key: vertex-label key carried in the dicts (the network glue
        reads ``vertex_labels`` with a ``vertex_markers`` fallback).

    Returns a list of refined per-fracture dicts (with both
    ``vertex_labels`` and ``vertex_markers`` set) ready for a new
    ``FractureNetworkMesh`` with the same corners.
    """
    tris = []
    for t in triangulations:
        v = np.asarray(t["vertices"], dtype=np.float64)
        tr = np.asarray(t["triangles"], dtype=np.int64)
        lab = t.get(label_key, t.get("vertex_markers"))
        if lab is None:
            lab = np.zeros((v.shape[0], 1), dtype=np.int64)
        tris.append((v, tr, np.asarray(lab, dtype=np.int64).reshape(-1, 1)))

    marked = _host(marked).astype(bool).reshape(-1)
    counts_c = [t[1].shape[0] for t in tris]
    if marked.shape[0] != sum(counts_c):
        raise ValueError(
            f"marked has {marked.shape[0]} entries for {sum(counts_c)} cells"
        )
    offsets_c = np.concatenate([[0], np.cumsum(counts_c)])
    n_verts = [t[0].shape[0] for t in tris]
    offsets_v = np.concatenate([[0], np.cumsum(n_verts)])
    gids = _host(mesh["global", "ids"]).reshape(-1)

    tables = []
    keys = []
    marks = []
    n_glob = int(gids.max()) + 1
    for f, (v, tr, _) in enumerate(tris):
        tab = _EdgeTables(v, tr)
        tables.append(tab)
        gpair = np.sort(
            gids[offsets_v[f] + tab.edges], axis=1
        )  # (E_f, 2) global ids
        keys.append(gpair[:, 0] * n_glob + gpair[:, 1])
        em = np.zeros(tab.edges.shape[0], dtype=bool)
        cell_marked = marked[offsets_c[f] : offsets_c[f + 1]]
        em[tab.longest_edge[cell_marked]] = True
        marks.append(em)

    # global fixpoint: per-fracture closure, then propagate marks on shared
    # (same global vertex pair) edges across fractures; both steps are
    # monotone in the marked sets, so the loop terminates
    all_keys = np.concatenate(keys)
    uniq_keys, key_inverse = np.unique(all_keys, return_inverse=True)
    bounds = np.concatenate([[0], np.cumsum([k.size for k in keys])])
    while True:
        for f in range(len(tris)):
            _closure(tables[f], marks[f])
        shared = np.zeros(uniq_keys.size, dtype=bool)
        flat_marks = np.concatenate(marks)
        np.logical_or.at(shared, key_inverse, flat_marks)
        new_flat = shared[key_inverse] & ~flat_marks
        if not new_flat.any():
            break
        for f in range(len(tris)):
            marks[f] |= new_flat[bounds[f] : bounds[f + 1]]

    refined = []
    for f, (v, tr, lab) in enumerate(tris):
        labels = _boundary_edge_labels(tables[f], lab)
        out, _ = _bisect(v, tr, lab, tables[f], marks[f], labels)
        out["vertex_labels"] = out["vertex_markers"]
        refined.append(out)
    return refined
