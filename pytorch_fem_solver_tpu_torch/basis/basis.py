"""Cell-volume basis on a single triangle mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/basis.py``, limited to P1
DOFs (the vertices); P2/P3 DOF maps, point probing and interpolation are
queued in ROADMAP.md (A12). Local entry (i, j) lands at global
(row_i, col_j), and interior-DOF lists are computed on the host once.
"""

from __future__ import annotations

from .abstract_basis import AbstractBasis


class Basis(AbstractBasis):
    """Lagrange P1 basis over mesh cells."""

    def _compute_dofs(self, mesh, element):
        if element.polynomial_order != 1:
            raise NotImplementedError(
                "the port has P1 DOF maps only; see ROADMAP.md, queue A12"
            )
        coords_4_global_dofs = mesh["vertices", "coordinates"]
        global_dofs_4_elements = mesh["cells", "vertices"]
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

    def _compute_jacobian_map(self, mesh, element):
        coords = self._cell_coordinates(mesh)
        return coords.mT @ element.barycentric_grad.to(coords)

    def _cell_coordinates(self, mesh):
        return mesh["cells", "coordinates"]

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ self._cell_coordinates(mesh)[..., None, :, :]
