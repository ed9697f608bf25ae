"""Adaptive local mesh refinement: longest-edge (Rivara) bisection.

Counterpart of ``pytorch_fem_solver_tpu/mesh/refinement.py``. Dörfler
marking picks the cells; every marked triangle bisects its longest edge,
and a closure pass keeps the mesh conforming (an edge being split forces
both adjacent triangles to split it). ``refine_adaptive_tet`` does the same
for tetrahedra in rounds: each round bisects, in every incident tet at
once, the wanted edges that are the longest edge of all their tets, so no
round leaves a hanging node. ``refine_network_adaptive`` extends the loop to fracture networks: the
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
    "refine_adaptive_tet",
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


def _tet_edge_tables(vertices, tets):
    """Unique-edge tables for a tet mesh: per-tet edge ids in the
    TET_EDGE_PERMUTATIONS layout, unique edge endpoints, and the tie-broken
    longest edge per tet (key = (length, global edge id), so every tet
    sharing an edge agrees on the comparison)."""
    from .topology import (
        TET_EDGE_PERMUTATIONS,
        _sort_unique_codes,
        encode_edge_pairs,
    )

    n_v = vertices.shape[0]
    local = np.sort(tets[:, TET_EDGE_PERMUTATIONS], axis=-1)  # (T, 6, 2)
    codes = encode_edge_pairs(local.reshape(-1, 2), n_v)
    _, edge_codes, inverse, _ = _sort_unique_codes(codes)
    e_ids = inverse.reshape(-1, 6)
    edges = np.stack(np.divmod(edge_codes, n_v), axis=1)  # (E, 2)
    lens = np.linalg.norm(
        vertices[edges[:, 0]] - vertices[edges[:, 1]], axis=1
    )
    tet_lens = lens[e_ids]  # (T, 6) — identical floats for a shared edge
    is_max = tet_lens == tet_lens.max(axis=1, keepdims=True)
    # among the longest edges of a tet, prefer the largest global edge id;
    # argmax over the masked ids also yields the local slot of that edge
    masked = np.where(is_max, e_ids, -1)
    longest_local = masked.argmax(axis=1)
    longest = masked[np.arange(tets.shape[0]), longest_local]
    return e_ids, edges, longest, longest_local


def _tet_boundary_edge_labels(tets, edges, markers, n_v):
    """Per unique-edge midpoint label: edges lying on a boundary face (face
    with a single incident tet) inherit the stronger endpoint label;
    interior edges stay 0. 3D counterpart of _boundary_edge_labels."""
    from .topology import encode_edge_pairs, tet_boundary_faces

    bf = tet_boundary_faces(tets, n_v)  # overflow-guarded dedup
    bf_edges = np.sort(bf[:, [[0, 1], [1, 2], [0, 2]]].reshape(-1, 2), axis=1)
    bf_codes = np.unique(encode_edge_pairs(bf_edges, n_v))
    on_boundary = np.isin(encode_edge_pairs(edges, n_v), bf_codes)
    ml = markers.reshape(-1)
    ends = np.maximum(ml[edges[:, 0]], ml[edges[:, 1]])
    return np.where(on_boundary, ends, 0).astype(np.int64)


def refine_adaptive_tet(
    triangulation: dict, marked, max_rounds: int = 500
) -> dict:
    """Conforming adaptive bisection of marked tetrahedra.

    Vectorized Rivara longest-edge bisection: per round, the set of edges
    that both (a) are wanted — the tie-broken longest edge of a marked tet,
    closed under "a tet touching a wanted edge wants its own longest edge"
    — and (b) are *terminal* — the longest edge of every tet containing
    them — is bisected simultaneously in all incident tets. Terminality
    makes each round exactly conforming: a face is split iff it contains
    the bisected edge, identically in both adjacent tets, so no hanging
    nodes ever exist between rounds. The maximal wanted edge is always
    terminal (every incident tet's longest edge is wanted by closure and
    cannot exceed it), so every round makes progress; rounds repeat until
    every originally marked tet has had its longest edge bisected once.

    The 3D counterpart of :func:`refine_adaptive`.

    Args:
      triangulation: dict with ``vertices`` (N, 3), ``tetrahedra`` (T, 4)
        (``cells``/``tets`` accepted) and optional ``vertex_markers``.
      marked: (T,) boolean mask of tets to bisect at least once (a
        tensor is read back to the host).
      max_rounds: safety cap on propagation rounds.

    Returns a new triangulation dict (``vertices``, ``tetrahedra``,
    ``vertex_markers``). Midpoints of boundary edges (edges on a face with
    a single incident tet) inherit the stronger endpoint marker.
    """
    from .topology import TET_EDGE_PERMUTATIONS

    out = dict(triangulation)
    for key in ("cells", "tets"):
        if "tetrahedra" not in out and key in out:
            out["tetrahedra"] = out[key]
    vertices = np.asarray(out["vertices"], dtype=np.float64)
    tets = np.asarray(out["tetrahedra"], dtype=np.int64)
    if "vertex_markers" in out and out["vertex_markers"] is not None:
        markers = np.asarray(out["vertex_markers"]).reshape(-1, 1)
    else:
        from .topology import build_tet_topology

        markers = build_tet_topology(vertices, tets)["vertex_markers"]
        markers = np.asarray(markers).reshape(-1, 1)

    marked = _host(marked).astype(bool).reshape(-1)
    if marked.shape[0] != tets.shape[0]:
        raise ValueError(
            f"marked has {marked.shape[0]} entries for {tets.shape[0]} cells"
        )

    rounds = 0
    while marked.any():
        if rounds >= max_rounds:  # pragma: no cover - safety net
            raise RuntimeError(
                f"refine_adaptive_tet did not converge in {max_rounds} rounds"
            )
        rounds += 1
        n_v = vertices.shape[0]
        e_ids, edges, longest, longest_local = _tet_edge_tables(
            vertices, tets
        )
        n_e = edges.shape[0]
        cnt_incident = np.bincount(e_ids.ravel(), minlength=n_e)
        cnt_longest = np.bincount(longest, minlength=n_e)
        terminal = cnt_longest == cnt_incident

        wanted = np.zeros(n_e, dtype=bool)
        wanted[longest[marked]] = True
        while True:
            touched = wanted[e_ids].any(axis=1)
            grow = touched & ~wanted[longest]
            if not grow.any():
                break
            wanted[longest[grow]] = True

        bisect = wanted & terminal
        split = bisect[longest]
        if not split.any():  # pragma: no cover - guaranteed nonempty
            raise RuntimeError("bisection stalled: no terminal wanted edge")

        labels = _tet_boundary_edge_labels(tets, edges, markers, n_v)
        bsel = np.flatnonzero(bisect)
        mid_of_edge = np.full(n_e, -1, dtype=np.int64)
        mid_of_edge[bsel] = n_v + np.arange(bsel.size)
        midpoints = vertices[edges[bsel]].mean(axis=1)
        mid_markers = labels[bsel].reshape(-1, 1)

        st = np.flatnonzero(split)
        pair = TET_EDGE_PERMUTATIONS[longest_local[st]]  # (S, 2) local i, j
        mids = mid_of_edge[longest[st]]
        rows = np.arange(st.size)
        child_a = tets[st].copy()
        child_a[rows, pair[:, 0]] = mids  # (m, j) half — det scales by 1/2
        child_b = tets[st].copy()
        child_b[rows, pair[:, 1]] = mids  # (i, m) half

        vertices = np.concatenate([vertices, midpoints], axis=0)
        markers = np.concatenate([markers, mid_markers], axis=0)
        tets = np.concatenate([tets[~split], child_a, child_b], axis=0)
        # a split tet is refined (children unmarked); unsplit keep marks
        marked = np.concatenate(
            [marked[~split], np.zeros(2 * st.size, dtype=bool)]
        )

    return {
        "vertices": vertices,
        "tetrahedra": tets,
        "vertex_markers": markers,
    }


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
