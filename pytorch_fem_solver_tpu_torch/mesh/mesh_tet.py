"""3D tetrahedral mesh as a keyed container of tensors.

Counterpart of ``pytorch_fem_solver_tpu/mesh/mesh_tet.py``: the
``MeshTri`` design one dimension up. All topology is derived once on the
host (NumPy, ``topology.build_tet_topology``) and frozen into tensors on one
device. Faces take the part edges play in 2D (the interior/boundary split,
the adjacent cells, the oriented normals); the unique edges are kept too,
since the P2/P3 DOFs live on them.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from .mesh_tri import MeshTri
from .topology import TET_EDGE_PERMUTATIONS, TET_FACE_PERMUTATIONS, build_tet_topology


class MeshTet(MeshTri):
    """A single 3D tetrahedral mesh with fully precomputed topology.

    ``device`` defaults to the card (``config.resolve_device``); ``dtype``
    to ``config.default_dtype()``.
    """

    #: local vertex pairs of the 6 tet edges
    edge_permutations = TET_EDGE_PERMUTATIONS
    #: local vertex triples of the 4 tet faces
    face_permutations = TET_FACE_PERMUTATIONS

    @staticmethod
    def _normalize_triangulation(triangulation: dict[str, Any]) -> dict[str, Any]:
        """Accept ``tetrahedra``, ``cells`` or (tetgen-style) ``tets`` keys."""
        t = dict(triangulation)
        for key in ("cells", "tets"):
            if "tetrahedra" not in t and key in t:
                t["tetrahedra"] = t[key]
        return t

    def _build_groups(self, triangulation: dict[str, Any]) -> dict:
        t = self._normalize_triangulation(triangulation)
        vertices = np.asarray(t["vertices"], dtype=np.float64)
        tets = np.asarray(t["tetrahedra"], dtype=np.int64)
        topo = build_tet_topology(vertices, tets, t.get("vertex_markers"))
        return {
            "vertices": {
                "coordinates": vertices,
                "markers": topo["vertex_markers"],
            },
            "cells": {
                "vertices": tets,
                "coordinates": vertices[tets],
                "length": topo["cells_min_length"],
            },
            "edges": {
                "vertices": topo["edges_vertices"],
                "markers": topo["edges_markers"],
            },
            "faces": {
                "vertices": topo["faces_vertices"],
                "markers": topo["faces_markers"],
            },
            "interior_faces": {
                "vertices": topo["interior_faces_vertices"],
                "cells": topo["interior_faces_cells"],
                "coordinates": vertices[topo["interior_faces_vertices"]],
                "area": topo["interior_faces_area"],
                "normals": topo["interior_faces_normals"],
            },
            "boundary_faces": {
                "vertices": topo["boundary_faces_vertices"],
                "cells": topo["boundary_faces_cells"],
                "coordinates": vertices[topo["boundary_faces_vertices"]],
            },
        }

    @property
    def n_interior_faces(self) -> int:
        return int(self["interior_faces", "vertices"].shape[-2])

    @property
    def n_interior_edges(self) -> int:
        raise AttributeError("MeshTet has faces, not interior edges")
