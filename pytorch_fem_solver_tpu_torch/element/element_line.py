"""P1/P2/P3 Lagrange segment reference element on [-1, 1].

Counterpart of ``pytorch_fem_solver_tpu/element/element_line.py``. Local
DOF order: the two endpoints, then P2 the midpoint, P3 the node at 2/3
toward endpoint 0 before the node at 2/3 toward endpoint 1, the cell's
edge-slot order, so that the facet bases append an edge's DOFs in the
order the traces use. The map Jacobian of an edge embedded in R^d is a
(d, 1) column; its "determinant" is the column norm (half-length scale)
and the pseudo-inverse is the reciprocal of that norm. Gauss-Legendre
rules come from ``element.quadrature``.
"""

from __future__ import annotations

import torch

from .abstract_element import AbstractElement
from .quadrature import line_rule


class ElementLine(AbstractElement):
    """Reference segment [-1, 1] with P1, P2 or P3 shape functions."""

    def __init__(self, polynomial_order: int, integration_order: int):
        if int(polynomial_order) not in (1, 2, 3):
            raise NotImplementedError("Polynomial order not implemented")
        super().__init__(polynomial_order, integration_order)

    @property
    def barycentric_grad(self) -> torch.Tensor:
        # grad of ((1-x)/2, (1+x)/2) on [-1, 1]
        return torch.tensor([[-0.5], [0.5]], dtype=torch.float64)

    @property
    def reference_element_area(self) -> float:
        return 2.0

    def compute_barycentric_coordinates(self, x):
        """(..., n_pts, 1) reference coords -> (..., n_pts, 2, 1) barycentric
        (the triangle's layout: points, n_loc, 1)."""
        return torch.stack([0.5 * (1.0 - x), 0.5 * (1.0 + x)], dim=-2)

    def compute_shape_functions(self, bar_coords, inv_map_jacobian):
        """Values (..., n_q, n_loc, 1) and physical gradients
        (..., 1|n_q, n_loc, d_inv)."""
        g = self.barycentric_grad.to(inv_map_jacobian)  # (2, 1)
        if self.polynomial_order == 1:
            return bar_coords, g @ inv_map_jacobian

        l1 = bar_coords[..., 0, :][..., None, :]
        l2 = bar_coords[..., 1, :][..., None, :]
        g1, g2 = g[0:1, :], g[1:2, :]
        if self.polynomial_order == 2:
            v = torch.cat([l1 * (2 * l1 - 1), l2 * (2 * l2 - 1), 4 * l1 * l2], dim=-2)
            grad_ref = torch.cat(
                [(4 * l1 - 1) * g1, (4 * l2 - 1) * g2, 4 * (l2 * g1 + l1 * g2)],
                dim=-2,
            )
            return v, grad_ref @ inv_map_jacobian

        v = torch.cat(
            [
                0.5 * l1 * (3 * l1 - 1) * (3 * l1 - 2),
                0.5 * l2 * (3 * l2 - 1) * (3 * l2 - 2),
                4.5 * l1 * l2 * (3 * l1 - 1),
                4.5 * l1 * l2 * (3 * l2 - 1),
            ],
            dim=-2,
        )
        grad_ref = torch.cat(
            [
                (13.5 * l1 * l1 - 9.0 * l1 + 1.0) * g1,
                (13.5 * l2 * l2 - 9.0 * l2 + 1.0) * g2,
                4.5 * (l2 * (6 * l1 - 1) * g1 + l1 * (3 * l1 - 1) * g2),
                4.5 * (l1 * (6 * l2 - 1) * g2 + l2 * (3 * l2 - 1) * g1),
            ],
            dim=-2,
        )
        return v, grad_ref @ inv_map_jacobian

    def _compute_gauss_values(self):
        return line_rule(self.integration_order)

    def compute_det_and_inv_map(self, map_jacobian):
        """Norm of the (d, 1) edge Jacobian column and its reciprocal.

        det (..., 1, 1, 1) for quadrature-weight broadcasting, inv
        (..., 1, 1, 1) with the quadrature broadcast axis (the triangle's
        (..., 1, d, d) layout).
        """
        det = torch.linalg.vector_norm(map_jacobian, dim=-2, keepdim=True)
        inv = 1.0 / det
        return det[..., None], inv[..., None]
