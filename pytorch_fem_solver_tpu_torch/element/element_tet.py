"""P1/P2/P3 Lagrange tetrahedron reference element.

Counterpart of ``pytorch_fem_solver_tpu/element/element_tet.py``: the
triangle's surface lifted one dimension. Local DOF order: P1 the vertices;
P2 the vertices, then the edges 01, 12, 02, 03, 13, 23
(``mesh.topology.TET_EDGE_PERMUTATIONS``); P3 the vertices, then per edge
the node near its first local vertex before the other (oriented globally by
``Basis._compute_dofs``), then one bubble per face in
``TET_FACE_PERMUTATIONS`` order. P1 gradients are constant per cell,
``(..., 1, 4, 3)``; P2/P3 gradients carry a real quadrature axis. Keast
rules of degree 1-5 come from ``element.quadrature``; the 3x3 determinant
and inverse (adjugate) of the affine map are analytic.
"""

from __future__ import annotations

import torch

from .abstract_element import AbstractElement
from .quadrature import tetrahedron_rule

_EDGES = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]
_FACES = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]


class ElementTet(AbstractElement):
    """Reference tetrahedron with vertices (0,0,0), (1,0,0), (0,1,0), (0,0,1)."""

    def __init__(self, polynomial_order: int, integration_order: int):
        if int(polynomial_order) not in (1, 2, 3):
            raise NotImplementedError("Polynomial order not implemented")
        super().__init__(polynomial_order, integration_order)

    @property
    def barycentric_grad(self) -> torch.Tensor:
        # grad of (1 - x - y - z, x, y, z) — rows are the 4 vertex basis fns
        return torch.tensor(
            [[-1.0, -1.0, -1.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]],
            dtype=torch.float64,
        )

    @property
    def reference_element_area(self) -> float:
        return 1.0 / 6.0

    def compute_barycentric_coordinates(self, x):
        """(..., n_pts, 3) reference coords -> (..., n_pts, 4, 1) barycentric."""
        lam1 = 1.0 - x[..., [0]] - x[..., [1]] - x[..., [2]]
        return torch.stack([lam1, x[..., [0]], x[..., [1]], x[..., [2]]], dim=-2)

    def compute_shape_functions(self, bar_coords, inv_map_jacobian):
        """Values (..., n_q, n_loc, 1) and physical gradients
        (..., 1|n_q, n_loc, 3)."""
        g = self.barycentric_grad.to(inv_map_jacobian)  # (4, 3)
        if self.polynomial_order == 1:
            # constant gradient per cell: (4,3) @ (..., 3, 3) -> (..., 4, 3)
            return bar_coords, g @ inv_map_jacobian

        lams = [bar_coords[..., i, :][..., None, :] for i in range(4)]
        gs = [g[i : i + 1, :] for i in range(4)]
        if self.polynomial_order == 2:
            v = torch.cat(
                [lam * (2 * lam - 1) for lam in lams]
                + [4 * lams[a] * lams[b] for a, b in _EDGES],
                dim=-2,
            )
            grad_ref = torch.cat(
                [(4 * lams[i] - 1) * gs[i] for i in range(4)]
                + [4 * (lams[b] * gs[a] + lams[a] * gs[b]) for a, b in _EDGES],
                dim=-2,
            )
            return v, grad_ref @ inv_map_jacobian

        # cubic: the edge node at lambda_a = 2/3, lambda_b = 1/3 is
        # edge(la, lb); each face's bubble sits at its barycenter
        def vert(la):
            return 0.5 * la * (3 * la - 1) * (3 * la - 2)

        def dvert(la, ga):
            return (13.5 * la * la - 9.0 * la + 1.0) * ga

        def edge(la, lb):
            return 4.5 * la * lb * (3 * la - 1)

        def dedge(la, lb, ga, gb):
            return 4.5 * (lb * (6 * la - 1) * ga + la * (3 * la - 1) * gb)

        v = torch.cat(
            [vert(lam) for lam in lams]
            + [
                f
                for a, b in _EDGES
                for f in (edge(lams[a], lams[b]), edge(lams[b], lams[a]))
            ]
            + [27.0 * lams[i] * lams[j] * lams[k] for i, j, k in _FACES],
            dim=-2,
        )
        grad_ref = torch.cat(
            [dvert(lams[i], gs[i]) for i in range(4)]
            + [
                f
                for a, b in _EDGES
                for f in (
                    dedge(lams[a], lams[b], gs[a], gs[b]),
                    dedge(lams[b], lams[a], gs[b], gs[a]),
                )
            ]
            + [
                27.0
                * (
                    lams[j] * lams[k] * gs[i]
                    + lams[i] * lams[k] * gs[j]
                    + lams[i] * lams[j] * gs[k]
                )
                for i, j, k in _FACES
            ],
            dim=-2,
        )
        return v, grad_ref @ inv_map_jacobian

    def _compute_gauss_values(self):
        return tetrahedron_rule(self.integration_order)

    def compute_det_and_inv_map(self, map_jacobian):
        """Analytic 3x3 det and inverse (adjugate) of J (..., 3, 3), with
        the triangle's broadcast layout: det (..., 1, 1, 1), inv
        (..., 1, 3, 3)."""
        a, b, c = map_jacobian[..., 0, 0], map_jacobian[..., 0, 1], map_jacobian[..., 0, 2]
        d, e, f = map_jacobian[..., 1, 0], map_jacobian[..., 1, 1], map_jacobian[..., 1, 2]
        g, h, i = map_jacobian[..., 2, 0], map_jacobian[..., 2, 1], map_jacobian[..., 2, 2]

        A = e * i - f * h
        B = f * g - d * i
        C = d * h - e * g
        det = a * A + b * B + c * C
        adj = torch.stack(
            [
                torch.stack([A, c * h - b * i, b * f - c * e], dim=-1),
                torch.stack([B, a * i - c * g, c * d - a * f], dim=-1),
                torch.stack([C, b * g - a * h, a * e - b * d], dim=-1),
            ],
            dim=-2,
        )
        inv = adj / det[..., None, None]
        return det[..., None, None, None], inv[..., None, :, :]
