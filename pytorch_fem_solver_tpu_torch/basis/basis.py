"""Cell-volume basis on a single triangle mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/basis.py``, limited to P1
DOFs (the vertices) and to interpolation onto the basis's own quadrature
points; P2/P3 DOF maps (ROADMAP.md, A6), point probing (A3) and
interpolation onto edge bases (A8) are queued. Local entry (i, j) lands at
global (row_i, col_j), and interior-DOF lists are computed on the host once.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

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

    def interpolate(self, basis, tensor: Optional[torch.Tensor] = None):
        """Evaluate a DOF vector (or nodal samples of a function) at this
        basis's own quadrature points (``basis is self``).

        With ``tensor`` (n_dofs, 1) returns ``(values (T, q, 1, 1),
        gradients (T, q, 1, d))``; without it, the pair of callables
        ``interpolator(f)`` and ``interpolator_grad(f)`` that do the same for
        the nodal samples ``f(coords)`` of a function. The two-sided and
        one-sided traces onto ``InteriorEdgesBasis`` / ``BoundaryEdgesBasis``
        are queued in ROADMAP.md (A8).
        """
        if basis is not self:
            raise NotImplementedError(
                "interpolation onto another basis (the edge bases) is not "
                "ported; see ROADMAP.md, queue A8"
            )
        dof_idx = self._global_dofs4elements[..., None, :]  # (T, 1, n_loc)
        v, v_grad = self.v, self.v_grad

        if tensor is not None:
            values = tensor[dof_idx]  # (T, 1, n_loc, 1)
            return (values * v).sum(-2, keepdim=True), (values * v_grad).sum(
                -2, keepdim=True
            )

        nodes = self._coords4global_dofs

        def interpolator(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v).sum(-2, keepdim=True)

        def interpolator_grad(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v_grad).sum(-2, keepdim=True)

        return interpolator, interpolator_grad
