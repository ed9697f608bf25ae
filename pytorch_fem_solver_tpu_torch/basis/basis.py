"""Cell-volume basis on a single triangle or tetrahedral mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/basis.py``: the P1, P2 and
P3 DOF maps of triangles and tetrahedra, with point probing queued
(ROADMAP.md, queue A item 3). ``interpolate`` evaluates on the basis's own
quadrature points and takes the two-sided and one-sided traces onto the
facet bases (the edges of a triangle mesh, the faces of a tet mesh). Local
entry (i, j) lands at global (row_i, col_j); the DOF tables and
interior-DOF lists are computed on the host once (NumPy, float64) and move
to the mesh's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..mesh.topology import (
    TET_EDGE_PERMUTATIONS,
    TET_FACE_PERMUTATIONS,
    TRI_DIRECTED_EDGES,
    edge_thirds,
    face_bubble_markers,
    p2_edge_dirichlet_markers,
    p3_edge_dofs,
    unique_edge_ids,
    unique_face_ids,
)
from .abstract_basis import AbstractBasis, dof_tables, host
from .interior_edges_basis import InteriorEdgesBasis


class Basis(AbstractBasis):
    """Lagrange basis over mesh cells: P1 (vertices), P2 (vertices + edge
    midpoints) or P3 (vertices + two oriented edge nodes + one bubble per
    cell on triangles, per unique face on tetrahedra)."""

    def _compute_dofs(self, mesh, element):
        order = element.polynomial_order
        if order == 1:
            coords_4_global_dofs = mesh["vertices", "coordinates"]
            global_dofs_4_elements = mesh["cells", "vertices"]
            nodes_4_boundary_dofs = mesh["vertices", "markers"]
        elif order in (2, 3):
            like = mesh["vertices", "coordinates"]
            verts = host(like).astype(np.float64)
            cells = host(mesh["cells", "vertices"]).astype(np.int64)
            is_tet = cells.shape[-1] == 4
            edges = host(mesh["edges", "vertices"]).astype(np.int64)
            vert_markers = host(mesh["vertices", "markers"]).reshape(-1)
            edge_markers = p2_edge_dirichlet_markers(
                edges, host(mesh["edges", "markers"]), vert_markers
            )
            n_vertices = verts.shape[0]
            cell_edges = unique_edge_ids(cells, edges, n_vertices)
            if order == 2:
                # one DOF per unique edge, at its midpoint
                coords = np.concatenate([verts, verts[edges].mean(axis=1)], axis=0)
                dofs = np.concatenate([cells, cell_edges + n_vertices], axis=1)
                markers = np.concatenate([vert_markers, edge_markers], axis=0)
            else:
                # two oriented DOFs per unique edge, then the bubbles: the
                # cell's barycenter on triangles, each unique face's on tets
                n_edges, n_cells = edges.shape[0], cells.shape[0]
                first_bubble = n_vertices + 2 * n_edges
                if is_tet:
                    directed = cells[:, TET_EDGE_PERMUTATIONS]
                    faces = host(mesh["faces", "vertices"]).astype(np.int64)
                    bubble = first_bubble + unique_face_ids(
                        faces, cells[:, TET_FACE_PERMUTATIONS], n_vertices
                    )
                    bubble_coords = verts[faces].mean(axis=1)
                    bubble_markers = face_bubble_markers(
                        faces, host(mesh["faces", "markers"]), vert_markers
                    )
                else:
                    directed = cells[:, TRI_DIRECTED_EDGES]
                    bubble = (first_bubble + np.arange(n_cells))[:, None]
                    bubble_coords = verts[cells].mean(axis=1)
                    bubble_markers = np.zeros(n_cells, np.int64)
                coords = np.concatenate(
                    [verts, edge_thirds(verts, edges), bubble_coords], axis=0
                )
                dofs = np.concatenate(
                    [cells, p3_edge_dofs(directed, cell_edges, n_vertices), bubble], axis=1
                )
                markers = np.concatenate(
                    [vert_markers, np.repeat(edge_markers, 2), bubble_markers]
                )
            coords_4_global_dofs, global_dofs_4_elements, nodes_4_boundary_dofs = (
                dof_tables(coords, dofs, markers, like)
            )
        else:
            raise NotImplementedError("Polynomial order not implemented")
        coords_4_elements = mesh.compute_coordinates_4_cells(
            coords_4_global_dofs, global_dofs_4_elements
        )
        return (
            coords_4_global_dofs,
            global_dofs_4_elements,
            nodes_4_boundary_dofs,
            coords_4_elements,
        )

    def _compute_basis_parameters(
        self, coords4global_dofs, global_dofs4elements, nodes4boundary_dofs
    ):
        return self._build_assembly_parameters(
            int(coords4global_dofs.shape[-2]),
            global_dofs4elements,
            nodes4boundary_dofs,
        )

    def _compute_jacobian_map(self, mesh, element):
        coords = self._cell_coordinates(mesh)
        return coords.mT @ element.barycentric_grad.to(coords)

    def _cell_coordinates(self, mesh):
        return mesh["cells", "coordinates"]

    def _interp_cell_coordinates(self):
        """Cell coordinates in the space the traces' points live in
        (3D for the embedded network basis)."""
        return self.mesh["cells", "coordinates"]

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ self._cell_coordinates(mesh)[..., None, :, :]

    def interpolate(self, basis, tensor: Optional[torch.Tensor] = None):
        """Evaluate a DOF vector (or nodal samples of a function) on another
        basis's quadrature points.

        * ``basis is self``: per-cell values and gradients at this basis's
          own quadrature points, ``(T, q, 1, 1)`` and ``(T, 1|q, 1, d)``
          (a quadrature axis of 1 for P1, whose gradients are constant per
          cell).
        * ``basis`` an :class:`InteriorEdgesBasis` (or an
          :class:`InteriorFacesBasis` of a tet mesh): two-sided traces. The
          facet quadrature points are pulled back into each adjacent cell's
          reference coordinates and the shape functions evaluated there,
          with a cell-pair axis at dim -4: ``(E, 2, q, 1, 1)`` and
          ``(E, 2, 1|q, 1, d)`` (jump terms).
        * ``basis`` a :class:`BoundaryEdgesBasis` (or
          :class:`BoundaryFacesBasis`): one-sided traces, the same with a
          side axis of size 1 (boundary fluxes).

        With ``tensor`` (n_dofs, 1) returns ``(values, gradients)``; without
        it, the pair of callables ``interpolator(f)`` and
        ``interpolator_grad(f)`` that do the same for the nodal samples
        ``f(coords)`` of a function (a network: autograd flows through the
        gather into its parameters).
        """
        if basis is self:
            dof_idx = self._global_dofs4elements[..., None, :]  # (T, 1, n_loc)
            v, v_grad = self.v, self.v_grad
        elif isinstance(basis, InteriorEdgesBasis):
            cells = basis._adjacent_cells()  # (E, n_sides) int64
            # (E, n_sides, 1, n_loc): DOF ids of the adjacent cells
            dof_idx = self._global_dofs4elements.long()[cells][..., None, :]
            # (E, n_sides, 1, 1, d): first vertex of each adjacent cell
            first_vertex = self._interp_cell_coordinates()[..., [0], :][cells][
                ..., None, :, :
            ]
            inv_map_jacobian = self._inv_map_jacobian[cells]  # (E, s, 1, d_ref, d)
            # edge quadrature points with an inserted side axis (E, 1, q, 1, d)
            pts = basis.integration_points[..., None, :, :, :]
            ref_pts = self._element.compute_inverse_map(
                first_vertex, pts, inv_map_jacobian
            )  # (E, s, q, 1, d_ref)
            bar_coords = self._element.compute_barycentric_coordinates(
                ref_pts.squeeze(-2)
            )  # (E, s, q, n_loc, 1)
            v, v_grad = self._element.compute_shape_functions(
                bar_coords, inv_map_jacobian
            )
        else:
            raise NotImplementedError("Interpolation for this basis not implemented")

        if tensor is not None:
            values = tensor[dof_idx]  # (..., 1, n_loc, 1)
            return (values * v).sum(-2, keepdim=True), (values * v_grad).sum(
                -2, keepdim=True
            )

        nodes = self._coords4global_dofs

        def interpolator(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v).sum(-2, keepdim=True)

        def interpolator_grad(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v_grad).sum(-2, keepdim=True)

        return interpolator, interpolator_grad
