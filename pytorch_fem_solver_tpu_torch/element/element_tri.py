"""P1 Lagrange triangle reference element.

Counterpart of ``pytorch_fem_solver_tpu/element/element_tri.py``, limited to
the P1 shape functions the DFN main path uses; P2/P3 raise (ROADMAP.md,
queue A12). Symmetric Gauss rules of degree 1-5 come from
``element.quadrature``; the 2x2 determinant and inverse of the affine map
are analytic.
"""

from __future__ import annotations

import torch

from .abstract_element import AbstractElement
from .quadrature import triangle_rule


class ElementTri(AbstractElement):
    """Reference triangle with vertices (0,0), (1,0), (0,1)."""

    def __init__(self, polynomial_order: int, integration_order: int):
        if int(polynomial_order) != 1:
            raise NotImplementedError(
                "the port has P1 triangles only; P2/P3 are queued in "
                "ROADMAP.md (A12)"
            )
        super().__init__(polynomial_order, integration_order)

    @property
    def barycentric_grad(self) -> torch.Tensor:
        # grad of (1 - x - y, x, y) — rows are the 3 vertex basis fns
        return torch.tensor(
            [[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]], dtype=torch.float64
        )

    @property
    def reference_element_area(self) -> float:
        return 0.5

    def compute_barycentric_coordinates(self, x):
        """(..., n_pts, 2) reference coords -> (..., n_pts, 3, 1) barycentric."""
        lam1 = 1.0 - x[..., [0]] - x[..., [1]]
        return torch.stack([lam1, x[..., [0]], x[..., [1]]], dim=-2)

    def compute_shape_functions(self, bar_coords, inv_map_jacobian):
        """Values (..., n_q, 3, 1) and physical gradients (..., 1, 3, 2)."""
        # constant gradient per cell: (3,2) @ (..., 2, 2) -> (..., 3, 2);
        # callers rely on broadcasting over the quadrature axis
        v_grad = self.barycentric_grad.to(inv_map_jacobian) @ inv_map_jacobian
        return bar_coords, v_grad

    def _compute_gauss_values(self):
        return triangle_rule(self.integration_order)

    def compute_det_and_inv_map(self, map_jacobian):
        """Analytic 2x2 det and inverse of J (..., 2, 2).

        Returns both with an extra broadcast axis for the quadrature
        dimension: det (..., 1, 1, 1), inv (..., 1, 2, 2).
        """
        a = map_jacobian[..., 0, 0]
        b = map_jacobian[..., 0, 1]
        c = map_jacobian[..., 1, 0]
        d = map_jacobian[..., 1, 1]

        det = a * d - b * c
        inv = torch.stack(
            [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)],
            dim=-2,
        ) / det[..., None, None]
        return det[..., None, None, None], inv[..., None, :, :]
