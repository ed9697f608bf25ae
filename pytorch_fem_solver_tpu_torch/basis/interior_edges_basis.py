"""1D quadrature bases over the interior and the boundary edges of a 2D mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/interior_edges_basis.py``.
The facet code here also serves the face bases of tetrahedral meshes
(``faces_basis.py``), which re-target ``facet_group``. P1 puts one DOF per
facet vertex (the global vertex ids); P2/P3 add the facet's own edge DOFs
(and, on a face at P3, its own bubble) with the numbering of the cell
``Basis``. Used for jump and flux functionals:
``integrate_functional`` over edges with the weights ``2 * w_q * |edge| / 2``,
and as the target of the two-sided (interior) and one-sided (boundary)
traces of ``Basis.interpolate``.
"""

from __future__ import annotations

import numpy as np

from ..mesh.topology import (
    TRI_DIRECTED_EDGES,
    edge_thirds,
    encode_edge_pairs,
    face_bubble_markers,
    p2_edge_dirichlet_markers,
    p3_edge_dofs,
    unique_face_ids,
)
from .abstract_basis import AbstractBasis, dof_tables, host


class InteriorEdgesBasis(AbstractBasis):
    """P1/P2/P3 basis on interior edges (line elements embedded in the mesh)."""

    #: mesh group the facet quadrature lives on; subclasses re-target it
    facet_group = "interior_edges"

    def _compute_dofs(self, mesh, element):
        order = element.polynomial_order
        if order == 1:
            coords_4_global_dofs = mesh["vertices", "coordinates"]
            global_dofs_4_elements = mesh[self.facet_group, "vertices"]
            nodes_4_boundary_dofs = mesh["vertices", "markers"]
        elif order in (2, 3):
            # the facet's vertices and its own edge DOFs, numbered as the
            # cell Basis numbers them (n_v + unique-edge id for P2; the two
            # oriented DOFs n_v + 2e, n_v + 2e + 1 for P3, whose bubble
            # block is the cells' barycenters on triangles, none on an edge,
            # and the faces' on tets, a face's own being its face id), so
            # facet-assembled forms land in the cell basis's global space
            like = mesh["vertices", "coordinates"]
            verts = host(like).astype(np.float64)
            edges_all = host(mesh["edges", "vertices"]).astype(np.int64)
            vert_markers = host(mesh["vertices", "markers"]).reshape(-1)
            edge_markers = p2_edge_dirichlet_markers(
                edges_all, host(mesh["edges", "markers"]), vert_markers
            )
            fv = host(mesh[self.facet_group, "vertices"]).astype(np.int64)
            is_face = fv.shape[1] == 3
            n_v = verts.shape[0]
            # (E, 1, 2): the edge itself; (F, 3, 2): a face's edges 01, 12, 20
            directed = fv[:, TRI_DIRECTED_EDGES] if is_face else fv[:, None, :]
            codes_all = encode_edge_pairs(np.sort(edges_all, axis=-1), n_v)
            edge_order = np.argsort(codes_all)
            pc = encode_edge_pairs(np.sort(directed.reshape(-1, 2), axis=-1), n_v)
            pos = np.searchsorted(codes_all[edge_order], pc)
            if (codes_all[edge_order][pos] != pc).any():
                raise ValueError("facet edge missing from the mesh's unique-edge table")
            facet_edges = edge_order[pos].reshape(directed.shape[:2])
            if order == 2:
                coords = np.concatenate([verts, verts[edges_all].mean(axis=1)], axis=0)
                dofs = np.concatenate([fv, facet_edges + n_v], axis=1)
                markers = np.concatenate([vert_markers, edge_markers], axis=0)
            else:
                dofs = [fv, p3_edge_dofs(directed, facet_edges, n_v)]
                if is_face:
                    faces = host(mesh["faces", "vertices"]).astype(np.int64)
                    own = unique_face_ids(faces, fv, n_v)
                    dofs.append((n_v + 2 * edges_all.shape[0] + own)[:, None])
                    bubble_coords = verts[faces].mean(axis=1)
                    bubble_markers = face_bubble_markers(
                        faces, host(mesh["faces", "markers"]), vert_markers
                    )
                else:
                    cells = host(mesh["cells", "vertices"]).astype(np.int64)
                    bubble_coords = verts[cells].mean(axis=1)
                    bubble_markers = np.zeros(cells.shape[0], dtype=np.int64)
                coords = np.concatenate(
                    [verts, edge_thirds(verts, edges_all), bubble_coords], axis=0
                )
                dofs = np.concatenate(dofs, axis=1)
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

    def _edge_coordinates(self, mesh):
        return mesh[self.facet_group, "coordinates"]

    def _adjacent_cells(self):
        """Cell ids adjacent to each facet, (E, n_sides) int64 on the
        mesh's device: two sides for interior facets (jump terms), one for
        boundary facets (flux traces). Widened once and kept, so the trace
        gathers of ``Basis.interpolate`` take no int32 index."""
        cells = getattr(self, "_adjacent_cells_long", None)
        if cells is None:
            cells = self.mesh[self.facet_group, "cells"].long()
            self._adjacent_cells_long = cells
        return cells

    def _compute_jacobian_map(self, mesh, element):
        coords = self._edge_coordinates(mesh)
        return coords.mT @ element.barycentric_grad.to(coords)

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ self._edge_coordinates(mesh)[..., None, :, :]


class BoundaryEdgesBasis(InteriorEdgesBasis):
    """Quadrature basis over the boundary edges of a 2D mesh: linear forms
    over it assemble Neumann/Robin terms into the global DOF vector, and
    ``integrate_functional`` gives boundary-flux functionals."""

    facet_group = "boundary_edges"
