"""Base class for reference elements.

Counterpart of ``pytorch_fem_solver_tpu/element/abstract_element.py``.
Quadrature tables are float64 CPU tensors built once at construction; a
basis casts them to its own device and dtype.
"""

from __future__ import annotations

import abc
from typing import Tuple

import torch


class AbstractElement(abc.ABC):
    """A reference element: shape functions + quadrature + affine-map algebra."""

    def __init__(self, polynomial_order: int, integration_order: int):
        self.polynomial_order = int(polynomial_order)
        self.integration_order = int(integration_order)

        nodes, weights = self._compute_gauss_values()
        #: (n_quad, dim) quadrature nodes on the reference element
        self.gaussian_nodes = torch.as_tensor(nodes, dtype=torch.float64)
        #: (n_quad, 1, 1) normalized quadrature weights (sum to 1) — shaped to
        #: broadcast against (..., n_cells, n_quad, n_loc, n_dim) integrands
        self.gaussian_weights = torch.as_tensor(
            weights, dtype=torch.float64
        ).reshape(-1, 1, 1)

    @property
    def n_quad(self) -> int:
        return int(self.gaussian_nodes.shape[0])

    def compute_inverse_map(self, first_node, integration_points, inv_map_jacobian):
        """Map physical points back to reference coordinates:
        x_ref = (x - first_node) @ J^{-T}."""
        return (integration_points - first_node) @ inv_map_jacobian.mT

    # -- abstract surface -------------------------------------------------

    @abc.abstractmethod
    def compute_shape_functions(self, bar_coords, inv_map_jacobian) -> Tuple:
        """Shape function values and physical gradients at barycentric coords."""

    @abc.abstractmethod
    def _compute_gauss_values(self):
        """Return (nodes, weights) numpy tables for the integration order."""

    @abc.abstractmethod
    def compute_barycentric_coordinates(self, x):
        """Barycentric coordinates of reference-element points x."""

    @abc.abstractmethod
    def compute_det_and_inv_map(self, map_jacobian):
        """Determinant (or metric) and inverse of the affine map Jacobian."""

    @property
    @abc.abstractmethod
    def reference_element_area(self) -> float:
        """Measure of the reference element."""

    @property
    @abc.abstractmethod
    def barycentric_grad(self) -> torch.Tensor:
        """(n_vertices, dim) gradients of barycentric coords on the ref element."""
