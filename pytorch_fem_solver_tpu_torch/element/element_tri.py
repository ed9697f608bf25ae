"""P1/P2/P3 Lagrange triangle reference element.

Counterpart of ``pytorch_fem_solver_tpu/element/element_tri.py``: the
triangle and ``ElementTriSurface``, the triangle chart embedded in R^3
that the face bases of tetrahedral meshes integrate on. Local DOF order: P1 the vertices; P2 the
vertices, then the edges 01, 12, 20; P3 the vertices, then per edge (01,
12, 20) the node near the first local vertex before the other, then the
bubble. P1 gradients are constant per cell, ``(..., 1, 3, 2)``, and callers
broadcast them over the quadrature axis; P2/P3 gradients carry a real
quadrature axis, ``(..., q, n_loc, 2)``. Symmetric Gauss rules of degree
1-5 come from ``element.quadrature``; the 2x2 determinant and inverse of
the affine map are analytic.
"""

from __future__ import annotations

import torch

from .. import config
from .abstract_element import AbstractElement
from .quadrature import triangle_rule


class ElementTri(AbstractElement):
    """Reference triangle with vertices (0,0), (1,0), (0,1)."""

    def __init__(self, polynomial_order: int, integration_order: int):
        if int(polynomial_order) not in (1, 2, 3):
            raise NotImplementedError("Polynomial order not implemented")
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

    @property
    def outward_normal(self) -> torch.Tensor:
        """Outward (unnormalized) edge normals of the reference triangle."""
        return torch.tensor(
            [[1.0, 1.0], [-1.0, 0.0], [0.0, -1.0]], dtype=config.default_dtype()
        )

    def compute_barycentric_coordinates(self, x):
        """(..., n_pts, 2) reference coords -> (..., n_pts, 3, 1) barycentric."""
        lam1 = 1.0 - x[..., [0]] - x[..., [1]]
        return torch.stack([lam1, x[..., [0]], x[..., [1]]], dim=-2)

    def compute_shape_functions(self, bar_coords, inv_map_jacobian):
        """Values (..., n_q, n_loc, 1) and physical gradients
        (..., 1|n_q, n_loc, 2)."""
        g = self.barycentric_grad.to(inv_map_jacobian)  # (3, 2)
        if self.polynomial_order == 1:
            # constant gradient per cell: (3,2) @ (..., 2, 2) -> (..., 3, 2);
            # callers rely on broadcasting over the quadrature axis
            return bar_coords, g @ inv_map_jacobian

        l1 = bar_coords[..., 0, :][..., None, :]
        l2 = bar_coords[..., 1, :][..., None, :]
        l3 = bar_coords[..., 2, :][..., None, :]
        g1, g2, g3 = g[0:1, :], g[1:2, :], g[2:3, :]

        if self.polynomial_order == 2:
            v = torch.cat(
                [
                    l1 * (2 * l1 - 1),
                    l2 * (2 * l2 - 1),
                    l3 * (2 * l3 - 1),
                    4 * l1 * l2,
                    4 * l2 * l3,
                    4 * l3 * l1,
                ],
                dim=-2,
            )
            grad_ref = torch.cat(
                [
                    (4 * l1 - 1) * g1,
                    (4 * l2 - 1) * g2,
                    (4 * l3 - 1) * g3,
                    4 * (l2 * g1 + l1 * g2),
                    4 * (l3 * g2 + l2 * g3),
                    4 * (l1 * g3 + l3 * g1),
                ],
                dim=-2,
            )
            return v, grad_ref @ inv_map_jacobian

        # cubic: the edge node at lambda_i = 2/3, lambda_j = 1/3 is
        # edge(li, lj); Basis._compute_dofs orients the two edge DOFs
        # globally (nearer the smaller global vertex id first), so adjacent
        # cells agree on the shared nodes
        def vert(li):
            return 0.5 * li * (3 * li - 1) * (3 * li - 2)

        def edge(li, lj):
            return 4.5 * li * lj * (3 * li - 1)

        def dvert(li, gi):
            return (13.5 * li * li - 9.0 * li + 1.0) * gi

        def dedge(li, lj, gi, gj):
            return 4.5 * (lj * (6 * li - 1) * gi + li * (3 * li - 1) * gj)

        v = torch.cat(
            [
                vert(l1),
                vert(l2),
                vert(l3),
                edge(l1, l2),
                edge(l2, l1),
                edge(l2, l3),
                edge(l3, l2),
                edge(l3, l1),
                edge(l1, l3),
                27.0 * l1 * l2 * l3,
            ],
            dim=-2,
        )
        grad_ref = torch.cat(
            [
                dvert(l1, g1),
                dvert(l2, g2),
                dvert(l3, g3),
                dedge(l1, l2, g1, g2),
                dedge(l2, l1, g2, g1),
                dedge(l2, l3, g2, g3),
                dedge(l3, l2, g3, g2),
                dedge(l3, l1, g3, g1),
                dedge(l1, l3, g1, g3),
                27.0 * (l2 * l3 * g1 + l1 * l3 * g2 + l1 * l2 * g3),
            ],
            dim=-2,
        )
        return v, grad_ref @ inv_map_jacobian

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


class ElementTriSurface(ElementTri):
    """Reference triangle mapped into R^d (d >= 2): the facet element of the
    face bases (``InteriorFacesBasis``, ``BoundaryFacesBasis``), as
    ``ElementLine`` is the edge bases'.

    The chart Jacobian J is a (d, 2) column pair; the measure is the Gram
    determinant ``sqrt(det(J^T J))`` (= |det J| when d = 2) and the
    "inverse" the pseudo-inverse ``(J^T J)^{-1} J^T``, so the shape
    functions' gradients are tangential gradients in ambient coordinates.
    """

    def compute_det_and_inv_map(self, map_jacobian):
        G = map_jacobian.mT @ map_jacobian  # (..., 2, 2)
        a, b = G[..., 0, 0], G[..., 0, 1]
        c, d = G[..., 1, 0], G[..., 1, 1]
        det_G = a * d - b * c
        adj = torch.stack(
            [torch.stack([d, -b], dim=-1), torch.stack([-c, a], dim=-1)], dim=-2
        )
        pinv = (adj @ map_jacobian.mT) / det_G[..., None, None]
        return torch.sqrt(det_G)[..., None, None, None], pinv[..., None, :, :]
