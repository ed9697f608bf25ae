"""Flat fracture-network mesh: ragged DFNs on one concatenated cell axis.

Counterpart of ``pytorch_fem_solver_tpu/mesh/fracture_network.py``.
Fractures of different sizes are concatenated along one flat cell axis with
per-cell fracture ids; the cross-fracture glue (3D vertex dedup -> global
DOF ids) happens here at construction, on the host, and the result is moved
to the device once.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .. import config
from .mesh_tri import MeshTri, _freeze
from .topology import build_tri_topology


def fit_affine_maps(anchors_2d: np.ndarray, corners_3d: np.ndarray):
    """Fit per-fracture x3d = J @ x2d + t from 3 point pairs.

    anchors_2d (F, 3, 2), corners_3d (F, 3, 3) ->
    (jac (F, 3, 2), trans (F, 3, 1), det (F,), inv_jac (F, 2, 3)).
    """
    F = anchors_2d.shape[0]
    extended = np.concatenate(
        [anchors_2d, np.ones((F, 3, 1))], axis=-1
    )  # (F, 3, 3)
    lineq = np.transpose(corners_3d, (0, 2, 1)) @ np.transpose(
        np.linalg.inv(extended), (0, 2, 1)
    )
    jac = lineq[..., :2]
    trans = lineq[..., 2:]
    det = np.linalg.norm(np.cross(jac[..., 0], jac[..., 1]), axis=-1)
    inv_jac = np.linalg.inv(np.transpose(jac, (0, 2, 1)) @ jac) @ np.transpose(
        jac, (0, 2, 1)
    )
    return jac, trans, det, inv_jac


class FractureNetworkMesh(MeshTri):
    """Concatenated DFN mesh with per-cell fracture ids and global DOF glue."""

    def __init__(
        self,
        triangulations: Optional[Sequence[dict]] = None,
        corners_3d=None,
        anchor_vertices_2d=None,
        tol: float = 1e-9,
        *,
        device=None,
        dtype: torch.dtype | None = None,
        _groups=None,
    ):
        if _groups is not None:
            self._t = _groups
            return
        device = config.resolve_device(device)

        F = len(triangulations)
        corners_3d = np.asarray(corners_3d, dtype=np.float64).reshape(F, -1, 3)[
            :, :3
        ]

        verts_list, tris_list, labels_list = [], [], []
        for t in triangulations:
            t = MeshTri._normalize_triangulation(t)
            v = np.asarray(t["vertices"], dtype=np.float64)
            verts_list.append(v)
            tris_list.append(np.asarray(t["triangles"], dtype=np.int64))
            labels = t.get("vertex_labels", t.get("vertex_markers"))
            if labels is None:
                labels = np.zeros((v.shape[0], 1), dtype=np.int64)
            labels_list.append(np.asarray(labels, dtype=np.int64).reshape(-1, 1))

        if anchor_vertices_2d is None:
            anchors = np.stack([v[:3] for v in verts_list], axis=0)
        else:
            anchors = np.asarray(anchor_vertices_2d, dtype=np.float64)[:, :3]

        jac, trans, det, inv_jac = fit_affine_maps(anchors, corners_3d)

        # flat concatenation with vertex offsets
        n_verts = np.array([v.shape[0] for v in verts_list])
        v_offsets = np.concatenate([[0], np.cumsum(n_verts)])
        flat_verts2d = np.concatenate(verts_list, axis=0)
        flat_labels = np.concatenate(labels_list, axis=0)
        flat_vertex_fracture = np.repeat(np.arange(F), n_verts)

        flat_cells = np.concatenate(
            [tris + v_offsets[f] for f, tris in enumerate(tris_list)], axis=0
        )
        cell_fracture = np.repeat(
            np.arange(F), [t.shape[0] for t in tris_list]
        )

        # 3D lift per vertex through its own fracture's map
        flat_verts3d = (
            np.einsum(
                "nij,nj->ni", jac[flat_vertex_fracture], flat_verts2d
            )
            + trans[flat_vertex_fracture, :, 0]
        )

        # per-fracture topology, concatenated with offsets
        topo_parts = [
            build_tri_topology(
                verts_list[f], tris_list[f], (labels_list[f] > 0).astype(np.int64)
            )
            for f in range(F)
        ]
        c_offsets = np.concatenate([[0], np.cumsum([t.shape[0] for t in tris_list])])

        def cat_with_offset(key, offset_by_vertex=False, offset_by_cell=False):
            parts = []
            for f, topo in enumerate(topo_parts):
                a = topo[key].copy()
                if offset_by_vertex:
                    a = a + v_offsets[f]
                if offset_by_cell:
                    a = a + c_offsets[f]
                parts.append(a)
            return np.concatenate(parts, axis=0)

        ie_vertices = cat_with_offset("interior_edges_vertices", offset_by_vertex=True)
        ie_cells = cat_with_offset("interior_edges_cells", offset_by_cell=True)
        ie_length = cat_with_offset("interior_edges_length")
        ie_normals = cat_with_offset("interior_edges_normals")
        be_vertices = cat_with_offset("boundary_edges_vertices", offset_by_vertex=True)
        be_cells = cat_with_offset("boundary_edges_cells", offset_by_cell=True)
        cells_length = cat_with_offset("cells_min_length")
        edges_vertices = cat_with_offset("edges_vertices", offset_by_vertex=True)
        edges_markers = cat_with_offset("edges_markers")
        ie_fracture = np.repeat(
            np.arange(F),
            [t["interior_edges_vertices"].shape[0] for t in topo_parts],
        )

        # interior-edge 3D geometry + lifted unit normals; the normal
        # transform is the pseudo-inverse transpose J (J^T J)^{-1} n — in
        # plane and perpendicular to the lifted edge for anisotropic charts
        ie_coords3d = flat_verts3d[ie_vertices]
        lifted = np.einsum(
            "eji,ej->ei", inv_jac[ie_fracture], ie_normals[:, 0, :]
        )
        lifted /= np.linalg.norm(lifted, axis=-1, keepdims=True)

        # ---- global glue: dedup 3D coords -> global DOF ids --------------
        # tolerance-robust grouping: a plain rounding grid can split one
        # physical trace vertex whose float copies straddle a cell boundary
        # (see mesh/dedup.py)
        from .dedup import tolerant_group

        scale = max(1.0, float(np.abs(flat_verts3d).max()))
        global_ids = tolerant_group(flat_verts3d, tol * scale)
        counts = np.bincount(global_ids)
        n_global = counts.shape[0]

        canonical = np.full(n_global, len(flat_verts3d), dtype=np.int64)
        np.minimum.at(canonical, global_ids, np.arange(len(flat_verts3d)))

        global_markers = np.zeros(n_global, dtype=np.int64)
        np.maximum.at(global_markers, global_ids, (flat_labels[:, 0] > 0).astype(np.int64))
        global_labels = np.zeros(n_global, dtype=np.int64)
        np.maximum.at(global_labels, global_ids, flat_labels[:, 0])

        trace_vertices = np.nonzero(counts > 1)[0]

        # trace edges: edges (as global vertex pairs) present in more than
        # one fracture's edge list. (Endpoints-both-trace-vertices is NOT
        # sufficient: near junctions an ordinary edge can connect vertices
        # of two different traces.)
        all_edges_global = np.sort(global_ids[edges_vertices], axis=-1)
        pair_key = all_edges_global[:, 0] * n_global + all_edges_global[:, 1]
        _, pair_inverse, pair_counts = np.unique(
            pair_key, return_inverse=True, return_counts=True
        )
        shared_pairs = pair_counts > 1

        ie_pairs = np.sort(global_ids[ie_vertices], axis=-1)
        ie_key = ie_pairs[:, 0] * n_global + ie_pairs[:, 1]
        shared_keys = np.unique(pair_key[shared_pairs[pair_inverse]])
        trace_edge_mask = np.isin(ie_key, shared_keys)

        groups = {
            "vertices": {
                "coordinates": flat_verts2d,
                "coordinates_3d": flat_verts3d,
                "markers": (flat_labels > 0).astype(np.int64),
                "labels": flat_labels,
                "fracture": flat_vertex_fracture.reshape(-1, 1),
            },
            "cells": {
                "vertices": flat_cells,
                "coordinates": flat_verts2d[flat_cells],
                "coordinates_3d": flat_verts3d[flat_cells],
                "fracture": cell_fracture.reshape(-1, 1),
                "length": cells_length,
            },
            "edges": {
                "vertices": edges_vertices,
                "markers": edges_markers,
            },
            "interior_edges": {
                "vertices": ie_vertices,
                "cells": ie_cells,
                "coordinates": flat_verts2d[ie_vertices],
                "coordinates_3d": ie_coords3d,
                "length": ie_length,
                "normals": ie_normals,
                "normals_3d": lifted[:, None, :],
                "fracture": ie_fracture.reshape(-1, 1),
                "trace_mask": trace_edge_mask.astype(np.int64).reshape(-1, 1),
            },
            "boundary_edges": {
                "vertices": be_vertices,
                "cells": be_cells,
                "coordinates": flat_verts2d[be_vertices],
            },
            "fracture_map": {
                "jacobian": jac,
                "translation": trans,
                "det": det.reshape(-1, 1, 1),
                "inv_jacobian": inv_jac,
            },
            "global": {
                "ids": global_ids.reshape(-1, 1),
                "canonical": canonical.reshape(-1, 1),
                "markers": global_markers.reshape(-1, 1),
                "labels": global_labels.reshape(-1, 1),
                "vertices_3d": flat_verts3d[canonical],
                "traces_vertices_idx": trace_vertices.reshape(-1, 1),
            },
        }
        self._t = _freeze(groups, device, dtype or config.default_dtype())

    def refined(self, marked) -> "FractureNetworkMesh":
        raise NotImplementedError(
            "adaptive DFN refinement (mesh/refinement.py:"
            "refine_network_adaptive) is not ported yet; see ROADMAP.md, "
            "queue A12"
        )

    @property
    def n_fractures(self) -> int:
        return int(self["fracture_map", "jacobian"].shape[0])

    @property
    def n_global_dofs(self) -> int:
        return int(self["global", "vertices_3d"].shape[0])
