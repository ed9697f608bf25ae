"""Basis over a flat (ragged) fracture network.

Counterpart of ``pytorch_fem_solver_tpu/basis/fracture_network_basis.py``:
glued global DOF ids (P1, P2 and P3, the edge DOFs shared across the
traces), tangential 3D gradients through each cell's fracture
pseudo-inverse, and fracture area scales in the weights; the traces onto
``InteriorEdgesNetworkBasis`` (P1, as in the JAX package) pull the edge
points back through each cell's embedded 2x3 inverse map.
"""

from __future__ import annotations

import numpy as np

from ..mesh.topology import (
    TRI_DIRECTED_EDGES,
    edge_thirds,
    encode_edge_pairs,
    p2_cell_edge_pairs,
    p3_edge_dofs,
)
from .abstract_basis import dof_tables, host
from .basis import Basis
from .interior_edges_basis import InteriorEdgesBasis


class FractureNetworkBasis(Basis):
    """P1/P2/P3 basis on the glued global DOFs of a flat fracture network."""

    def __init__(self, mesh, element):
        super().__init__(mesh, element)

        # tangential 3D gradients: per-cell gather of the fracture
        # pseudo-inverse — (T, 1|q, n_loc, 2) @ (T, 1, 2, 3) -> (T, 1|q, n_loc, 3)
        cell_frac = mesh["cells", "fracture"][:, 0].long()
        inv_frac = mesh["fracture_map", "inv_jacobian"][cell_frac][:, None]
        self.v_grad = self.v_grad @ inv_frac
        self._inv_map_jacobian = self._inv_map_jacobian @ inv_frac

    def _compute_dofs(self, mesh, element):
        order = element.polynomial_order
        if order == 1:
            global_ids = mesh["global", "ids"][:, 0]
            coords_4_global_dofs = mesh["global", "vertices_3d"]
            global_dofs_4_elements = global_ids[mesh["cells", "vertices"].long()]
            nodes_4_boundary_dofs = mesh["global", "markers"]
        elif order in (2, 3):
            # the glued triangulation: trace edges carry the same global
            # vertex pair in every incident fracture, so the edge DOFs (the
            # P2 midpoint, the two oriented P3 nodes) are shared across
            # fractures; the P3 bubble is per cell
            like = mesh["global", "vertices_3d"]
            global_ids = host(mesh["global", "ids"])[:, 0].astype(np.int64)
            gverts = host(like).astype(np.float64)
            gmark = host(mesh["global", "markers"]).reshape(-1)
            gcells = global_ids[host(mesh["cells", "vertices"])]
            n_gverts, n_cells = gverts.shape[0], gcells.shape[0]
            edges, inverse = np.unique(
                p2_cell_edge_pairs(gcells).reshape(-1, 2), axis=0, return_inverse=True
            )
            cell_edges = inverse.reshape(-1, 3)
            # an edge DOF is Dirichlet iff its global edge is a boundary
            # edge of at least one incident fracture and both endpoints are
            # marked (a network-wide incidence count would miss outer
            # boundary edges shared by two glued fracture borders)
            be_pairs = np.sort(
                global_ids[host(mesh["boundary_edges", "vertices"])], axis=-1
            )
            edge_mark = (
                np.isin(encode_edge_pairs(edges, n_gverts), encode_edge_pairs(be_pairs, n_gverts))
                & (gmark[edges[:, 0]] != 0)
                & (gmark[edges[:, 1]] != 0)
            ).astype(np.int64)
            if order == 2:
                coords = np.concatenate([gverts, gverts[edges].mean(axis=1)], axis=0)
                dofs = np.concatenate([gcells, cell_edges + n_gverts], axis=1)
                markers = np.concatenate([gmark, edge_mark], axis=0)
            else:
                directed = gcells[:, TRI_DIRECTED_EDGES]
                bubble = n_gverts + 2 * edges.shape[0] + np.arange(n_cells)
                coords = np.concatenate(
                    [gverts, edge_thirds(gverts, edges), gverts[gcells].mean(axis=1)], axis=0
                )
                dofs = np.concatenate(
                    [gcells, p3_edge_dofs(directed, cell_edges, n_gverts), bubble[:, None]],
                    axis=1,
                )
                markers = np.concatenate(
                    [gmark, np.repeat(edge_mark, 2), np.zeros(n_cells, dtype=np.int64)]
                )
            coords_4_global_dofs, global_dofs_4_elements, nodes_4_boundary_dofs = (
                dof_tables(coords, dofs, markers, like)
            )
        else:
            raise NotImplementedError("Polynomial order not implemented")
        coords_4_elements = coords_4_global_dofs[global_dofs_4_elements.long()]
        return (
            coords_4_global_dofs,
            global_dofs_4_elements,
            nodes_4_boundary_dofs,
            coords_4_elements,
        )

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ mesh["cells", "coordinates_3d"][..., None, :, :]

    def _compute_integral_weights(self, element, det_map_jacobian):
        cell_frac = self.mesh["cells", "fracture"][:, 0].long()
        scale = self.mesh["fracture_map", "det"][cell_frac][..., None]  # (T,1,1,1)
        return super()._compute_integral_weights(element, det_map_jacobian) * scale

    def _interp_cell_coordinates(self):
        return self.mesh["cells", "coordinates_3d"]


class InteriorEdgesNetworkBasis(InteriorEdgesBasis):
    """Edge quadrature basis over a flat fracture network, embedded in 3D.

    Used for flux-jump functionals across element edges and traces; the edge
    metric comes from the lifted 3D coordinates (exact for any affine map).
    """

    def _compute_dofs(self, mesh, element):
        if element.polynomial_order != 1:
            raise NotImplementedError("Polynomial order not implemented")
        global_ids = mesh["global", "ids"][:, 0]
        coords_4_global_dofs = mesh["global", "vertices_3d"]
        global_dofs_4_elements = global_ids[mesh["interior_edges", "vertices"].long()]
        nodes_4_boundary_dofs = mesh["global", "markers"]
        coords_4_elements = coords_4_global_dofs[global_dofs_4_elements.long()]
        return (
            coords_4_global_dofs,
            global_dofs_4_elements,
            nodes_4_boundary_dofs,
            coords_4_elements,
        )

    def _edge_coordinates(self, mesh):
        return mesh["interior_edges", "coordinates_3d"]
