"""Basis over a flat (ragged) fracture network.

Counterpart of ``pytorch_fem_solver_tpu/basis/fracture_network_basis.py``
for P1: glued global DOF ids, tangential 3D gradients through each cell's
fracture pseudo-inverse, and fracture area scales in the weights. The P2/P3
branches and ``InteriorEdgesNetworkBasis`` are queued in ROADMAP.md (A12).
"""

from __future__ import annotations

from .basis import Basis


class FractureNetworkBasis(Basis):
    """P1 basis on the glued global DOFs of a flat fracture network."""

    def __init__(self, mesh, element):
        super().__init__(mesh, element)

        # tangential 3D gradients: per-cell gather of the fracture
        # pseudo-inverse — (T, 1, n_loc, 2) @ (T, 1, 2, 3) -> (T, 1, n_loc, 3)
        cell_frac = mesh["cells", "fracture"][:, 0].long()
        inv_frac = mesh["fracture_map", "inv_jacobian"][cell_frac][:, None]
        self.v_grad = self.v_grad @ inv_frac
        self._inv_map_jacobian = self._inv_map_jacobian @ inv_frac

    def _compute_dofs(self, mesh, element):
        if element.polynomial_order != 1:
            raise NotImplementedError(
                "the port has P1 network DOF maps only; see ROADMAP.md, "
                "queue A12"
            )
        global_ids = mesh["global", "ids"][:, 0]
        coords_4_global_dofs = mesh["global", "vertices_3d"]
        global_dofs_4_elements = global_ids[mesh["cells", "vertices"].long()]
        nodes_4_boundary_dofs = mesh["global", "markers"]
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
