"""P1 Lagrange segment reference element on [-1, 1].

Counterpart of ``pytorch_fem_solver_tpu/element/element_line.py``, limited
to the P1 shape functions the edge bases use; P2/P3 raise (ROADMAP.md,
queue A item 6). The map Jacobian of an edge embedded in R^d is a (d, 1)
column; its "determinant" is the column norm (half-length scale) and the
pseudo-inverse is the reciprocal of that norm. Gauss-Legendre rules come
from ``element.quadrature``.
"""

from __future__ import annotations

import torch

from .abstract_element import AbstractElement
from .quadrature import line_rule


class ElementLine(AbstractElement):
    """Reference segment [-1, 1] with P1 shape functions."""

    def __init__(self, polynomial_order: int, integration_order: int):
        if int(polynomial_order) != 1:
            raise NotImplementedError(
                "the port has P1 segments only; P2/P3 are queued in "
                "ROADMAP.md (queue A, item 6)"
            )
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
        """Values (..., n_q, 2, 1) and physical gradients (..., 2, d_inv)."""
        v_grad = self.barycentric_grad.to(inv_map_jacobian) @ inv_map_jacobian
        return bar_coords, v_grad

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
