"""Template-method core of the basis/assembly layer.

Counterpart of ``pytorch_fem_solver_tpu/basis/abstract_basis.py``, limited to
what the compiled BSR solve, the DFN benchmark and RVPINN training read. All
quadrature-evaluated tensors (shape values, physical gradients, integration
points, weights, DOF and scatter indices) are computed once at construction
on the mesh's device; the integrate methods are plain functions of them, and
the assembled forms are out-of-place scatter-adds that autograd
differentiates (the VPINN loss differentiates them twice).

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

    def integrate_functional(
        self, function: Callable[..., torch.Tensor], *args: Any, **kwargs: Any
    ) -> torch.Tensor:
        """Per-cell integral of a functional: sums quadrature and local axes."""
        return (
            (self._evaluate_form(function, self, *args, **kwargs) * self._dx)
            .sum(-3)
            .sum(-2)
        )

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

    # -- assembly (differentiable scatter-add) ------------------------------

    def integrate_bilinear_form(
        self, function: Callable[..., torch.Tensor], *args: Any, **kwargs: Any
    ) -> torch.Tensor:
        """Assembled dense global matrix (n_dofs, n_dofs)."""
        return self._assemble_bilinear_from_local(
            self.integrate_bilinear_form_local(function, *args, **kwargs)
        )

    def _assemble_bilinear_from_local(self, local: torch.Tensor) -> torch.Tensor:
        """Scatter element matrices (..., T, n_loc, n_loc) into the dense
        global matrix: local entry (i, j) of a cell adds at (row_i, col_j)."""
        values = self.reshape_for_assembly(local, "bilinear")
        n_rows, n_cols = self._basis_parameters["bilinear_form_shape"]
        rows, cols = self._basis_parameters["bilinear_form_idx"]
        flat = rows.long() * n_cols + cols.long()
        return values.new_zeros(n_rows * n_cols).index_add(0, flat, values).reshape(
            n_rows, n_cols
        )

    def integrate_linear_form(
        self, function: Callable[..., torch.Tensor], *args: Any, **kwargs: Any
    ) -> torch.Tensor:
        """Assembled global load vector (n_dofs, 1)."""
        return self._assemble_linear_from_local(
            self.integrate_linear_form_local(function, *args, **kwargs)
        )

    def _assemble_linear_from_local(self, local: torch.Tensor) -> torch.Tensor:
        """Scatter element vectors (..., T, n_loc, 1) into the global load
        vector. Out-of-place ``index_add``, so training differentiates
        through it (twice, for losses built on the network's input
        gradient). An index tuple of another length is the JAX
        ``.at[idx].add``: an accumulating ``index_put``."""
        values = self.reshape_for_assembly(local, "linear")
        shape = self._basis_parameters["linear_form_shape"]
        idx = self._basis_parameters["linear_form_idx"]
        if len(idx) == 1:
            return values.new_zeros(shape).index_add(0, idx[0], values)
        return values.new_zeros(shape).index_put(
            tuple(i.long() for i in idx), values, accumulate=True
        )

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

    def gram_solver(
        self, form: Callable[..., torch.Tensor], method: str = "cholesky"
    ) -> Callable[[torch.Tensor], torch.Tensor]:
        """Differentiable ``r -> G^{-1} r`` on the reduced DOFs, G the Gram
        matrix of ``form`` on this basis (the RVPINN loss ``r^T G^{-1} r``).

        ``method="cholesky"`` factors the dense reduced Gram once; each
        application is a pair of triangular solves. The returned callable
        takes ``(n_inner, 1)`` or ``(n_inner,)`` vectors and keeps the shape.
        ``method="pcg"`` (matrix-free, with warm starts) is queued in
        ROADMAP.md (A10).
        """
        if method == "pcg":
            raise NotImplementedError(
                "gram_solver(method='pcg') needs the ELL operator "
                "(ops/sparse.py) and the two-level preconditioner; see "
                "ROADMAP.md, queue A10"
            )
        if method != "cholesky":
            raise ValueError(
                f"unknown gram_solver method: {method!r} "
                "(expected 'cholesky' or 'pcg')"
            )
        factor = torch.linalg.cholesky(self.reduce(self.integrate_bilinear_form(form)))

        def solve(r: torch.Tensor) -> torch.Tensor:
            if r.dim() == 1:
                return torch.cholesky_solve(r[:, None], factor)[:, 0]
            return torch.cholesky_solve(r, factor)

        return solve

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
