"""Glue of a stored fracture network, worked out again from the file.

Each fracture's chart vertices are lifted to 3D by the affine map that
takes its three anchors to its three corners; vertices of different
fractures that lie within ``glue_tol`` times the largest coordinate of each
other are one node (a k-d tree's close pairs, then connected components);
a node is Dirichlet where any of its copies carries a label above 0. A
cell keeps its own fracture's lift of its vertices: copies of one trace
vertex may lie up to the tolerance apart.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components
from scipy.spatial import cKDTree

from .p1 import Glued


def glue(inp: dict) -> Glued:
    vc, tc = inp["vertex_counts"], inp["triangle_counts"]
    F = len(vc)
    v_off = np.concatenate([[0], np.cumsum(vc)])
    t_off = np.concatenate([[0], np.cumsum(tc)])
    points = np.empty((int(v_off[-1]), 3))
    cells = np.empty((int(t_off[-1]), 3), dtype=np.int64)
    for f in range(F):
        a = np.concatenate([inp["anchors_2d"][f], np.ones((3, 1))], axis=1)  # (3, 3)
        m = np.linalg.solve(a, inp["corners_3d"][f])  # [x, y, 1] @ m = x3d
        chart = inp["vertices"][v_off[f]:v_off[f + 1]]
        points[v_off[f]:v_off[f + 1]] = np.concatenate([chart, np.ones((len(chart), 1))], axis=1) @ m
        cells[t_off[f]:t_off[f + 1]] = inp["triangles"][t_off[f]:t_off[f + 1]] + v_off[f]
    n = len(points)
    tol = inp["glue_tol"] * max(1.0, float(np.abs(points).max()))
    pairs = cKDTree(points).query_pairs(r=tol, output_type="ndarray")
    graph = coo_matrix((np.ones(len(pairs)), (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    n_nodes, node = connected_components(graph, directed=False)
    dirichlet = np.zeros(n_nodes, dtype=bool)
    np.logical_or.at(dirichlet, node, inp["labels"] > 0)
    return Glued(points[cells], node[cells], dirichlet, node)
