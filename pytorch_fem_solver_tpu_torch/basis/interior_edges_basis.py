"""1D quadrature bases over the interior and the boundary edges of a 2D mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/interior_edges_basis.py``,
limited to the P1 DOF map (each facet's local DOFs are its vertex ids, the
global vertex numbering); the P2/P3 facet maps are queued in ROADMAP.md
(queue A, item 6). Used for jump and flux functionals: ``integrate_functional``
over edges with the weights ``2 * w_q * |edge| / 2``, and as the target of the
two-sided (interior) and one-sided (boundary) traces of
``Basis.interpolate``.
"""

from __future__ import annotations

from .abstract_basis import AbstractBasis


class InteriorEdgesBasis(AbstractBasis):
    """P1 basis on interior edges (line elements embedded in the mesh)."""

    #: mesh group the facet quadrature lives on; subclasses re-target it
    facet_group = "interior_edges"

    def _compute_dofs(self, mesh, element):
        if element.polynomial_order != 1:
            raise NotImplementedError(
                "the port has P1 facet DOF maps only; P2/P3 are queued in "
                "ROADMAP.md (queue A, item 6)"
            )
        coords_4_global_dofs = mesh["vertices", "coordinates"]
        global_dofs_4_elements = mesh[self.facet_group, "vertices"]
        nodes_4_boundary_dofs = mesh["vertices", "markers"]
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
    """P1 quadrature basis over the boundary edges of a 2D mesh: linear
    forms over it assemble Neumann/Robin terms into the global vertex DOF
    vector, and ``integrate_functional`` gives boundary-flux functionals."""

    facet_group = "boundary_edges"
