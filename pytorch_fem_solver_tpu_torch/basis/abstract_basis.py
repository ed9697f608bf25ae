"""Template-method core of the basis/assembly layer.

Counterpart of ``pytorch_fem_solver_tpu/basis/abstract_basis.py``, limited to
what the compiled BSR solve and the DFN benchmark read. All
quadrature-evaluated tensors (shape values, physical gradients, integration
points, weights, DOF and scatter indices) are computed once at construction
on the mesh's device; the integrate methods are plain functions of them.

Tensor-shape convention (identical to the JAX package): integrands broadcast
over trailing dims (..., n_cells, n_quad, n_loc, n_dim).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Tuple

import numpy as np
import torch

from .. import config


class AbstractBasis(abc.ABC):
    """Couples a mesh and a reference element into an integration op set."""

    def __init__(self, mesh, element):
        self._element = element
        self.mesh = mesh

        (
            self.v,
            self.v_grad,
            self.integration_points,
            self._dx,
            self._inv_map_jacobian,
        ) = self._compute_integral_values(mesh, element)

        (
            self._coords4global_dofs,
            self._global_dofs4elements,
            self._nodes4boundary_dofs,
            self._coords4elements,
        ) = self._compute_dofs(mesh, element)

        self._basis_parameters = self._compute_basis_parameters(
            self._coords4global_dofs,
            self._global_dofs4elements,
            self._nodes4boundary_dofs,
        )

    # -- construction pipeline --------------------------------------------

    def _compute_integral_values(self, mesh, element):
        """Evaluate shape functions / weights at quadrature points (once)."""
        map_jacobian = self._compute_jacobian_map(mesh, element)

        det_map_jacobian, inv_map_jacobian = element.compute_det_and_inv_map(
            map_jacobian
        )

        bar_coords = element.compute_barycentric_coordinates(
            element.gaussian_nodes.to(map_jacobian)
        )

        v, v_grad = element.compute_shape_functions(bar_coords, inv_map_jacobian)

        integration_points = self._compute_integration_points(mesh, bar_coords)

        dx = self._compute_integral_weights(element, det_map_jacobian)

        return v, v_grad, integration_points, dx, inv_map_jacobian

    # -- integration ------------------------------------------------------

    @staticmethod
    def _evaluate_form(function, *args, **kwargs):
        """Evaluate a user form.

        The JAX package raises the matmul precision here because TPU f32
        matmuls default to bf16 passes; the port pins TF32 off globally in
        ``config``, so float32 products are already full precision.
        """
        return function(*args, **kwargs)

    def integrate_bilinear_form_local(
        self, function: Callable[..., torch.Tensor], *args: Any, **kwargs: Any
    ) -> torch.Tensor:
        """Unassembled element matrices (..., n_cells, n_loc, n_loc)."""
        return (
            self._evaluate_form(function, self, *args, **kwargs) * self._dx
        ).sum(-3)

    def integrate_linear_form_local(
        self, function: Callable[..., torch.Tensor], *args: Any, **kwargs: Any
    ) -> torch.Tensor:
        """Unassembled element load vectors (..., n_cells, n_loc, 1)."""
        return (
            self._evaluate_form(function, self, *args, **kwargs) * self._dx
        ).sum(-3)

    # -- reduction --------------------------------------------------------

    def reduce(self, tensor: torch.Tensor) -> torch.Tensor:
        """Restrict a global matrix/vector to interior (non-Dirichlet) DOFs."""
        idx = self._basis_parameters["inner_dofs"].long()
        if tensor.shape[-1] != 1:
            return tensor[..., idx, :][..., :, idx]
        return tensor[..., idx, :]

    def solution_tensor(self) -> torch.Tensor:
        """Zero-initialized global DOF vector (n_dofs, 1)."""
        return torch.zeros(
            self._basis_parameters["linear_form_shape"],
            dtype=self.dtype,
            device=self.device,
        )

    def compiled_solver(self, bilinear_form, linear_form=None, **kwargs):
        """Assemble+solve pipeline for this basis (BSR path).

        Builds every host structure once and returns ``solve() -> (u,
        PCGInfo)``; see :func:`ops.compiled.compiled_bsr_solver` for options.
        """
        from ..ops.compiled import compiled_bsr_solver

        return compiled_bsr_solver(self, bilinear_form, linear_form, **kwargs)

    # -- abstract surface -------------------------------------------------

    @abc.abstractmethod
    def _compute_dofs(self, mesh, element) -> Tuple:
        """DOF coordinates/maps: (coords4global_dofs, global_dofs4elements,
        nodes4boundary_dofs, coords4elements)."""

    @abc.abstractmethod
    def _compute_basis_parameters(
        self, coords4global_dofs, global_dofs4elements, nodes4boundary_dofs
    ) -> dict:
        """Assembly shapes + scatter indices + interior DOF list."""

    @abc.abstractmethod
    def _compute_jacobian_map(self, mesh, element):
        """Affine map Jacobian from reference to physical element."""

    @abc.abstractmethod
    def _compute_integration_points(self, mesh, bar_coords):
        """Physical quadrature points per element."""

    def _compute_integral_weights(self, element, det_map_jacobian):
        """Quadrature weights x reference measure x det J (x extra scales)."""
        weights = element.gaussian_weights.to(det_map_jacobian)
        return element.reference_element_area * weights * det_map_jacobian

    def _build_assembly_parameters(
        self,
        nb_global_dofs: int,
        global_dofs4elements,
        nodes4boundary_dofs,
    ) -> dict:
        """Shared scatter-index / interior-DOF construction.

        The JAX package's batched layout (patch and fracture-edge bases,
        ``batch_size``) is not ported yet (ROADMAP.md, A9d).
        """
        nb_local_dofs = int(global_dofs4elements.shape[-1])
        markers = self._as_host_index(nodes4boundary_dofs).reshape(-1)
        inner_dofs = torch.as_tensor(
            np.nonzero(markers != 1)[0].astype(np.int32),
            dtype=config.index_dtype(),
            device=global_dofs4elements.device,
        )
        dofs = global_dofs4elements
        rows_idx = torch.repeat_interleave(dofs, nb_local_dofs, dim=-1).reshape(-1)
        cols_idx = dofs.repeat(1, nb_local_dofs).reshape(-1)
        return {
            "bilinear_form_shape": (nb_global_dofs, nb_global_dofs),
            "bilinear_form_idx": (rows_idx, cols_idx),
            "linear_form_shape": (nb_global_dofs, 1),
            "linear_form_idx": (dofs.reshape(-1),),
            "inner_dofs": inner_dofs,
            "nb_dofs": nb_global_dofs,
        }

    # -- helpers ----------------------------------------------------------

    def reshape_for_assembly(self, local: torch.Tensor, form: str) -> torch.Tensor:
        """Flatten local element tensors into the scatter-value layout."""
        if form == "bilinear":
            return local.reshape(-1)
        if form == "linear":
            return local.reshape(-1, 1)
        raise NotImplementedError(f"Unknown form type: {form}")

    @property
    def n_dofs(self) -> int:
        return int(self._basis_parameters["nb_dofs"])

    @property
    def element(self):
        return self._element

    @property
    def device(self) -> torch.device:
        return self._global_dofs4elements.device

    @property
    def dtype(self) -> torch.dtype:
        return self._dx.dtype

    @staticmethod
    def _as_host_index(array) -> np.ndarray:
        """Host copy of an index array for dynamic-shape setup math."""
        if isinstance(array, torch.Tensor):
            return array.cpu().numpy()
        return np.asarray(array)
