"""2D triangular mesh as a keyed container of tensors.

Counterpart of ``pytorch_fem_solver_tpu/mesh/mesh_tri.py``. All topology is
derived once on the host (NumPy), then frozen into tensors on one device and
grouped in a nested dict, so ``mesh["cells", "vertices"]`` reads the same as
in the JAX package.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from .. import config
from .topology import build_tri_topology


def _freeze(tree, device, dtype):
    """Nested dict of NumPy arrays -> the same dict of tensors on ``device``.

    Float arrays take ``dtype``; integer arrays become the index dtype
    (int32, as in the JAX package).
    """
    if isinstance(tree, dict):
        return {k: _freeze(v, device, dtype) for k, v in tree.items()}
    x = np.asarray(tree)
    if np.issubdtype(x.dtype, np.floating):
        return torch.tensor(x, dtype=dtype, device=device)
    return torch.tensor(x.astype(np.int32), dtype=config.index_dtype(), device=device)


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


class MeshTri:
    """A single 2D triangle mesh with fully precomputed topology.

    ``device`` defaults to the card (``config.resolve_device``); ``dtype``
    to ``config.default_dtype()``.
    """

    def __init__(
        self,
        triangulation: dict[str, Any] | None = None,
        *,
        device=None,
        dtype: torch.dtype | None = None,
        _groups=None,
    ):
        if _groups is not None:
            self._t = _groups
            return
        if triangulation is None:
            raise ValueError("MeshTri requires a triangulation dict")
        self._t = _freeze(
            self._build_groups(triangulation),
            config.resolve_device(device),
            dtype or config.default_dtype(),
        )

    # -- construction -----------------------------------------------------

    @staticmethod
    def _normalize_triangulation(triangulation: dict[str, Any]) -> dict[str, Any]:
        """Accept both our schema and triangle-library key spellings."""
        t = dict(triangulation)
        if "triangles" not in t and "cells" in t:
            t["triangles"] = t["cells"]
        return t

    def _build_groups(self, triangulation: dict[str, Any]) -> dict:
        t = self._normalize_triangulation(triangulation)
        vertices = np.asarray(t["vertices"], dtype=np.float64)
        triangles = np.asarray(t["triangles"], dtype=np.int64)
        topo = build_tri_topology(vertices, triangles, t.get("vertex_markers"))
        return {
            "vertices": {
                "coordinates": vertices,
                "markers": topo["vertex_markers"],
            },
            "cells": {
                "vertices": triangles,
                "coordinates": vertices[triangles],
                "length": topo["cells_min_length"],
            },
            "edges": {
                "vertices": topo["edges_vertices"],
                "markers": topo["edges_markers"],
            },
            "interior_edges": {
                "vertices": topo["interior_edges_vertices"],
                "cells": topo["interior_edges_cells"],
                "coordinates": vertices[topo["interior_edges_vertices"]],
                "length": topo["interior_edges_length"],
                "normals": topo["interior_edges_normals"],
            },
            "boundary_edges": {
                "vertices": topo["boundary_edges_vertices"],
                "cells": topo["boundary_edges_cells"],
                "coordinates": vertices[topo["boundary_edges_vertices"]],
            },
        }

    def to(self, device=None, dtype: torch.dtype | None = None):
        """Copy with every tensor moved to ``device`` and every float tensor
        cast to ``dtype`` (index tensors keep their dtype)."""

        def move(x):
            if dtype is not None and x.is_floating_point():
                return x.to(device=device, dtype=dtype)
            return x.to(device=device)

        obj = type(self).__new__(type(self))
        obj.__dict__.update(self.__dict__)
        obj._t = _map_tree(self._t, move)
        return obj

    # -- keyed access -------------------------------------------------------

    def __getitem__(self, key: str | Tuple[str, ...]):
        node = self._t
        if isinstance(key, tuple):
            for k in key:
                node = node[k]
            return node
        return node[key]

    def __setitem__(self, key: str | Tuple[str, ...], value) -> None:
        if isinstance(key, tuple):
            node = self._t
            for k in key[:-1]:
                node = node.setdefault(k, {})
            node[key[-1]] = value
        else:
            self._t[key] = value

    def refined(self, marked):
        """Adaptively refined copy on the same device and dtype: conforming
        longest-edge bisection of the marked cells (``mesh.refinement``),
        built from the host copies of this mesh's tables. Mirrors
        ``FractureNetworkMesh.refined`` so estimator-driven loops read the
        same on every mesh family. A tetrahedral mesh bisects through
        ``refine_adaptive_tet``."""
        from .refinement import _host, refine_adaptive, refine_adaptive_tet

        cells = _host(self["cells", "vertices"])
        tri = {
            "vertices": _host(self["vertices", "coordinates"]),
            "vertex_markers": _host(self["vertices", "markers"]),
        }
        if cells.shape[-1] == 4:
            tri["tetrahedra"] = cells
            refined = refine_adaptive_tet(tri, marked)
        else:
            tri["triangles"] = cells
            refined = refine_adaptive(tri, marked)
        return type(self)(refined, device=self.device, dtype=self.dtype)

    # -- sizes ------------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self["cells", "vertices"].device

    @property
    def dtype(self) -> torch.dtype:
        return self["vertices", "coordinates"].dtype

    @property
    def n_vertices(self) -> int:
        return int(self["vertices", "coordinates"].shape[-2])

    @property
    def n_cells(self) -> int:
        return int(self["cells", "vertices"].shape[-2])

    @property
    def n_interior_edges(self) -> int:
        return int(self["interior_edges", "vertices"].shape[-2])

    @property
    def dim(self) -> int:
        return int(self["vertices", "coordinates"].shape[-1])

    # -- gathers ----------------------------------------------------------

    @staticmethod
    def compute_coordinates_4_cells(coordinates_4_vertices, vertices_4_cells):
        """Gather per-cell data: out[c, i] = coords[cells[c, i]]."""
        return coordinates_4_vertices[vertices_4_cells.long()]
