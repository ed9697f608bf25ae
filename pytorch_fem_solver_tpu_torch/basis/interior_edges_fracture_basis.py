"""Quadrature basis over the interior edges of batched fracture meshes (in 3D).

Counterpart of ``pytorch_fem_solver_tpu/basis/interior_edges_fracture_basis.py``
on the batched ``FracturesTri`` layout: the normal-flux jump terms across
element edges and fracture traces. The quadrature geometry comes from the
lifted 3D edge coordinates, so the arc-length element is exact for any
affine fracture map; the DOFs are each fracture's edge endpoint vertices,
with a leading fracture axis in the assembly layout.
"""

from __future__ import annotations

from .abstract_basis import AbstractBasis


class InteriorEdgesFractureBasis(AbstractBasis):
    """P1 edge basis over the interior edges of each fracture, embedded in 3D."""

    def __init__(self, mesh, element):
        self.nb_fractures = int(mesh.batch_size()[0])
        super().__init__(mesh, element)

    def _compute_dofs(self, mesh, element):
        if element.polynomial_order != 1:
            raise NotImplementedError(
                "the fracture edge basis is P1 (as in the JAX package)"
            )
        coords_4_global_dofs = mesh["vertices", "coordinates_3d"]
        global_dofs_4_elements = mesh["interior_edges", "vertices"]  # (B, Ei, 2)
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
            batch_size=self.nb_fractures,
        )

    def reshape_for_assembly(self, local, form: str):
        if form == "bilinear":
            return local.reshape(self.nb_fractures, -1)
        if form == "linear":
            return local.reshape(self.nb_fractures, -1, 1)
        raise NotImplementedError(f"Unknown form type: {form}")

    def _compute_jacobian_map(self, mesh, element):
        # 3D edge coordinates: the metric includes the fracture stretch
        coords = mesh["interior_edges", "coordinates_3d"]
        return coords.mT @ element.barycentric_grad.to(coords)

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ mesh["interior_edges", "coordinates_3d"][..., None, :, :]
