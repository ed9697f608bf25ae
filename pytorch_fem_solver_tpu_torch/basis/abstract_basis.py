"""Template-method core of the basis/assembly layer.

Counterpart of ``pytorch_fem_solver_tpu/basis/abstract_basis.py``: the
forms (the two-space mixed forms of the Stokes solvers too), the dense and
iterative solves (BSR, ELL and segment operators, the rigid-body-mode
preconditioner of vector bases), Newton (eager and compiled, the Jacobian
by ``torch.func.jvp``), the Gram solvers of RVPINN training, and the
compiled BSR, refined and eigen solves. All quadrature-evaluated tensors
(shape values, physical gradients, integration points, weights, DOF and
scatter indices) are computed once at construction on the mesh's device;
the integrate methods are plain functions of them, and the assembled forms
are out-of-place scatter-adds that autograd differentiates (the VPINN loss
differentiates them twice).

Tensor-shape convention (identical to the JAX package): integrands broadcast
over trailing dims (..., n_cells, n_quad, n_loc, n_dim).
"""

from __future__ import annotations

import abc
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from .. import config


def host(t) -> np.ndarray:
    """Host NumPy copy of a tensor (or array)."""
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def dof_tables(coords, dofs, markers, like: torch.Tensor):
    """Host-built P2/P3 DOF tables as ``(coords4global_dofs,
    global_dofs4elements, nodes4boundary_dofs)`` on ``like``'s device:
    coordinates in its dtype, DOF ids and ``(..., n, 1)`` markers int32."""
    index = config.index_dtype()
    markers = np.asarray(markers).astype(np.int32)
    return (
        torch.tensor(np.asarray(coords), dtype=like.dtype, device=like.device),
        torch.tensor(np.asarray(dofs).astype(np.int32), dtype=index, device=like.device),
        torch.tensor(markers.reshape(markers.shape + (1,)), dtype=index, device=like.device),
    )


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

    def integrate_mixed_bilinear_form_local(
        self,
        trial_basis: "AbstractBasis",
        function: Callable[..., torch.Tensor],
        *args: Any,
        **kwargs: Any,
    ) -> torch.Tensor:
        """Unassembled two-space element matrices ``(T, n_test_loc,
        n_trial_loc)``: ``self`` carries the test functions and the
        quadrature weights, ``trial_basis`` the trial functions; the form
        receives ``(test_basis, trial_basis, *args)``. Both bases must live
        on the same mesh object with the same integration order, so their
        quadrature points coincide. The saddle-point operators of
        ``ops.saddle`` apply these without assembling the coupling block."""
        if trial_basis.mesh is not self.mesh:
            raise ValueError("mixed forms need test and trial bases on the same mesh")
        if trial_basis._element.integration_order != self._element.integration_order:
            raise ValueError(
                "mixed forms need matching integration orders (got "
                f"{self._element.integration_order} test vs "
                f"{trial_basis._element.integration_order} trial)"
            )
        return (
            self._evaluate_form(function, self, trial_basis, *args, **kwargs) * self._dx
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
        global matrix: local entry (i, j) of a cell adds at (row_i, col_j)
        (of batch entry b, in the batched layout)."""
        values = self.reshape_for_assembly(local, "bilinear")
        shape = self._basis_parameters["bilinear_form_shape"]
        idx = self._basis_parameters["bilinear_form_idx"]
        if len(idx) == 3:  # the batched layout: the JAX ``.at[b, r, c].add``
            return values.new_zeros(shape).index_put(
                tuple(i.long() for i in idx), values, accumulate=True
            )
        n_rows, n_cols = shape
        rows, cols = idx
        flat = rows.long() * n_cols + cols.long()
        return values.new_zeros(n_rows * n_cols).index_add(0, flat, values).reshape(
            n_rows, n_cols
        )

    def integrate_mixed_bilinear_form(
        self,
        trial_basis: "AbstractBasis",
        function: Callable[..., torch.Tensor],
        *args: Any,
        **kwargs: Any,
    ) -> torch.Tensor:
        """Assembled dense two-space matrix ``(n_test, n_trial)`` of
        :meth:`integrate_mixed_bilinear_form_local` (same contract and
        checks; unbatched meshes): local entry (i, j) of a cell adds at
        (test DOF i, trial DOF j), e.g. the Taylor-Hood coupling B[q, u] =
        -∫ q div u."""
        local = self.integrate_mixed_bilinear_form_local(trial_basis, function, *args, **kwargs)
        rows = self._global_dofs4elements.long()
        cols = trial_basis._global_dofs4elements.long()
        n_cols = trial_basis.n_dofs
        flat = (rows[..., :, None] * n_cols + cols[..., None, :]).reshape(-1)
        return local.new_zeros(self.n_dofs * n_cols).index_add(
            0, flat, local.reshape(-1)
        ).reshape(self.n_dofs, n_cols)

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

    def solve(
        self,
        matrix: torch.Tensor,
        solution: torch.Tensor,
        vector: torch.Tensor,
        only_inner_dofs: bool = True,
    ) -> torch.Tensor:
        """Direct (dense LU) solve. Returns a new solution vector with the
        interior DOFs' update added; for large systems use
        ``solve_iterative``."""
        if only_inner_dofs:
            matrix = self.reduce(matrix)
            vector = self.reduce(vector)
        update = torch.linalg.solve(matrix, vector)
        inner = self._basis_parameters["inner_dofs"]
        return solution.index_add(solution.dim() - 2, inner, update)

    def dirichlet_lift(self, matrix, vector, boundary_values):
        """Impose non-homogeneous Dirichlet data by lifting.

        Given assembled (matrix, vector) and a DOF vector carrying the
        boundary values (entries at interior DOFs are ignored), returns
        ``(u_bc, rhs)`` with the boundary contribution moved to the right-
        hand side: ``solve(matrix, u_bc, rhs)`` then holds the boundary
        values exactly.
        """
        inner = self._basis_parameters["inner_dofs"].long()
        u_bc = boundary_values.index_fill(boundary_values.dim() - 2, inner, 0.0)
        return u_bc, vector - matrix @ u_bc

    def solve_iterative(
        self,
        local_matrices: torch.Tensor,
        vector: torch.Tensor,
        solution: Optional[torch.Tensor] = None,
        tol: float = 1e-10,
        maxiter: Optional[int] = None,
        only_inner_dofs: bool = True,
        method: str = "bsr",
        precondition: str = "jacobi",
        symmetric_form: bool = False,
        return_info: bool = False,
        solver: str = "cg",
    ):
        """Matrix-free preconditioned Krylov solve of the reduced system.

        Never materializes the global matrix. ``method="bsr"`` (default)
        assembles into the 8x8 block-sparse operator with spatially
        reordered DOFs, whose SpMV is the kernel K2; ``method="ell"`` uses
        the scalar-gather hybrid-ELL operator; ``method="segment"`` keeps
        the per-cell gather/matvec/segment-sum operator. Structures are
        cached on the basis.

        ``precondition``: ``"jacobi"``; ``"agg_block"`` (BSR: aggregate
        blocks of the smoother plus the dense coarse level); ``"two_level"``
        (BSR: ``auto_preconditioner``, the rigid-body-mode coarse space on a
        vector basis; ELL: the smoothed two-level M, its tables cached on
        the basis); ``"rbm"`` (BSR, vector bases: the rigid-body-mode
        coarse space by name; a scalar basis raises ``ValueError``);
        ``"mult_two_level"`` (BSR: the symmetrized multiplicative V(1,1)
        cycle over the block two-level M, its smoother damped by 12
        power-iteration SpMVs at setup; 3 SpMVs per iteration).
        ``symmetric_form=True`` asserts
        symmetric local matrices and takes the canonical-pair assembly (BSR
        only). ``solver="bicgstab"`` is for non-symmetric operators. With
        ``return_info`` the result is ``(u, PCGInfo)``.
        """
        from ..ops.solvers import bicgstab, pcg

        if solver == "cg":
            krylov = pcg
        elif solver == "bicgstab":
            krylov = bicgstab
        else:
            raise ValueError(
                f"unknown solver: {solver!r} (expected 'cg' or 'bicgstab')"
            )

        if symmetric_form and method != "bsr":
            raise ValueError(
                "symmetric_form=True is only implemented for method='bsr' "
                f"(got method={method!r}); drop the flag or switch methods"
            )

        if solution is None:
            solution = self.solution_tensor()

        if method == "bsr":
            if not only_inner_dofs:
                raise NotImplementedError(
                    "method='bsr' solves the reduced (interior-DOF) system"
                )
            if precondition not in (
                "two_level", "agg_block", "mult_two_level", "rbm", "jacobi"
            ):
                raise ValueError(
                    f"unknown precondition: {precondition!r} (expected "
                    "'two_level', 'agg_block', 'mult_two_level', 'rbm' or "
                    "'jacobi')"
                )
            from ..ops.bsr import (
                bsr_diagonal,
                bsr_expand,
                bsr_matvec,
                bsr_reduce,
                bsr_values_from_local,
                bsr_values_from_local_symmetric,
                default_max_b,
                get_bsr_structure,
            )
            from ..ops.precondition import (
                agg_block_two_level_from_values,
                auto_preconditioner,
                mult_two_level_from_values,
                rbm_two_level_setup,
            )

            structure = get_bsr_structure(
                self, max_b=default_max_b(self), want_entry_slot=not symmetric_form
            )
            if symmetric_form:
                values = bsr_values_from_local_symmetric(structure, local_matrices)
            else:
                values = bsr_values_from_local(structure, local_matrices)
            diag = bsr_diagonal(structure, values)
            precond = None
            if precondition == "two_level":
                precond = auto_preconditioner(self, structure, values, diag)
            elif precondition == "agg_block":
                precond = agg_block_two_level_from_values(structure, values, diag)
            elif precondition == "mult_two_level":
                precond = mult_two_level_from_values(structure, values, diag)
            elif precondition == "rbm":
                precond = rbm_two_level_setup(self, structure)(values, diag)
            x, info = krylov(
                lambda v: bsr_matvec(structure, values, v),
                bsr_reduce(structure, vector),
                precond_diag=diag,
                precond=precond,
                tol=tol,
                maxiter=maxiter,
            )
            u = solution + bsr_expand(structure, x, self.n_dofs)
            return (u, info) if return_info else u

        rhs = self.reduce(vector) if only_inner_dofs else vector

        if method == "segment":
            if precondition == "two_level":
                raise NotImplementedError(
                    "precondition='two_level' requires method='ell'"
                )
            from ..ops.operators import reduced_operator_from_local

            matvec, diag = reduced_operator_from_local(self, local_matrices)
            precond = None
        else:
            from ..ops.sparse import (
                ell_diagonal,
                ell_matvec,
                ell_values_from_local,
                get_ell_structure,
            )

            structure = get_ell_structure(self, max_k=8)
            values = ell_values_from_local(structure, local_matrices)
            diag = ell_diagonal(structure, values)
            matvec = lambda x: ell_matvec(structure, values, x)  # noqa: E731
            precond = None
            if precondition == "two_level":
                from ..ops.precondition import two_level_from_values

                precond = two_level_from_values(
                    self._two_level_tables(structure), structure, values, diag
                )

        x, info = krylov(
            matvec,
            rhs[..., 0],
            precond_diag=diag,
            precond=precond,
            tol=tol,
            maxiter=maxiter,
        )
        inner = self._basis_parameters["inner_dofs"]
        u = solution.index_add(solution.dim() - 2, inner, x[..., None])
        return (u, info) if return_info else u

    # -- Newton ---------------------------------------------------------

    def _iterate_at_quadrature(self, u_cells: torch.Tensor):
        """Evaluate a local-coefficient block (..., T, n_loc) at quadrature
        points: values ``(..., T, q, 1, 1)`` and gradients
        ``(..., T, q, 1, d)`` for scalar bases; ``(..., T, q, 1, nc)`` and
        ``(..., T, q, 1, nc, d)`` for vector bases (whose ``v_grad``
        carries the extra component axis). Newton differentiates through
        this with ``torch.func.jvp``."""
        vals = u_cells[..., None, :, None]
        uh = (vals * self.v).sum(-2, keepdim=True)
        if int(getattr(self, "n_components", 1)) >= 2:
            ugh = (u_cells[..., None, :, None, None] * self.v_grad).sum(-3, keepdim=True)
        else:
            ugh = (vals * self.v_grad).sum(-2, keepdim=True)
        return uh, ugh

    def _residual_local(self, residual_form, u_cells, args):
        """Element residual vectors (..., T, n_loc, 1) of ``residual_form``
        at the local coefficients ``u_cells``."""
        uh, ugh = self._iterate_at_quadrature(u_cells)
        integrand = self._evaluate_form(residual_form, self, uh, ugh, *args)
        return (integrand * self._dx).sum(-3)

    def _newton_terms(self, residual_local, u_cells):
        """The assembled residual and the consistent Jacobian's element
        matrices (..., T, n_loc, n_loc): column j is the ``torch.func.jvp``
        of ``residual_local`` against the one-hot tangent of local DOF j,
        in the JAX package's order."""
        n_loc = int(u_cells.shape[-1])
        r_local, cols = None, []
        for j in range(n_loc):
            tangent = torch.zeros_like(u_cells)
            tangent[..., j] = 1.0
            primal, col = torch.func.jvp(residual_local, (u_cells,), (tangent,))
            r_local = primal if r_local is None else r_local
            cols.append(col)  # (..., T, n_loc, 1)
        return self._assemble_linear_from_local(r_local), torch.cat(cols, dim=-1)

    def solve_newton(
        self,
        residual_form: Callable[..., torch.Tensor],
        *args: Any,
        solution: Optional[torch.Tensor] = None,
        tol: float = 1e-10,
        max_iter: int = 25,
        damping: bool = True,
        return_info: bool = False,
        **solve_kwargs: Any,
    ):
        """Newton's method for nonlinear problems F(u)[v] = 0.

        ``residual_form(basis, u, u_grad, *args)`` returns the weak-residual
        integrand against every test function, shaped ``(..., T, q, n_loc,
        1)`` like a linear-form integrand, where ``u`` ``(..., T, q, 1, 1)``
        and ``u_grad`` ``(..., T, q, 1, d)`` are the current iterate at the
        quadrature points (``(..., T, q, 1, nc)`` and ``(..., T, q, 1, nc,
        d)`` on a vector basis). The consistent Jacobian's element matrices
        come from ``torch.func.jvp`` (``n_loc`` forward passes, each over
        all cells) and feed :meth:`solve_iterative`, whose ``solver``
        defaults to ``"bicgstab"`` and ``tol`` to ``min(tol, 1e-8)``.

        Dirichlet data rides on ``solution`` (the initial iterate, zeros by
        default); updates touch interior DOFs only. ``damping=True`` halves
        the step, at most 12 times, while the reduced residual norm does not
        decrease (``res_new >= norms[-1]``, for a finite ``norms[-1]``).
        Stops when the reduced residual norm is at most ``tol * max(1,
        initial norm)`` or after ``max_iter`` iterations. With
        ``return_info=True`` also returns ``{"iterations",
        "residual_norms", "converged"}`` (an int, a list of floats, a bool).
        """
        solve_kwargs.setdefault("solver", "bicgstab")
        solve_kwargs.setdefault("tol", min(tol, 1e-8))
        if solution is None:
            solution = self.solution_tensor()
        u = solution
        dofs = self._global_dofs4elements.long()

        def residual_local(u_cells):
            return self._residual_local(residual_form, u_cells, args)

        def residual_norm(u_vec):
            r = self._assemble_linear_from_local(residual_local(u_vec[..., 0][..., dofs]))
            return float(torch.linalg.norm(self.reduce(r)))

        res0 = residual_norm(u)
        norms = [res0]
        target = tol * max(1.0, res0)
        converged = res0 <= target
        iterations = 0
        for iterations in range(1, max_iter + 1):
            if converged:
                iterations -= 1
                break
            residual, j_local = self._newton_terms(residual_local, u[..., 0][..., dofs])
            delta = self.solve_iterative(j_local, -residual, **solve_kwargs)
            # backtracking: res_new always describes the step actually taken
            step = 1.0
            res_new = residual_norm(u + step * delta)
            halvings = 0
            while (
                damping
                and np.isfinite(norms[-1])
                and res_new >= norms[-1]
                and halvings < 12
            ):
                step *= 0.5
                res_new = residual_norm(u + step * delta)
                halvings += 1
            u = u + step * delta
            norms.append(res_new)
            converged = res_new <= target
        if return_info:
            return u, {
                "iterations": iterations,
                "residual_norms": norms,
                "converged": bool(converged),
            }
        return u

    def _two_level_tables(self, structure):
        """The ELL two-level tables (``leaf=32, kp=4``) of this basis's
        interior DOFs, built once and cached as ``_two_level_structure``."""
        from ..ops.precondition import build_two_level_structure

        tl = getattr(self, "_two_level_structure", None)
        if tl is None:
            inner = self._as_host_index(self._basis_parameters["inner_dofs"])
            coords = self._coords4global_dofs.cpu().numpy()[inner]
            tl = build_two_level_structure(structure, coords, leaf=32, kp=4)
            self._two_level_structure = tl
        return tl

    def gram_solver(
        self,
        form: Callable[..., torch.Tensor],
        method: str = "cholesky",
        tol: Optional[float] = None,
        maxiter: Optional[int] = None,
        precondition: str = "two_level",
    ) -> Callable[..., torch.Tensor]:
        """Differentiable ``r -> G^{-1} r`` on the reduced DOFs, G the Gram
        matrix of ``form`` on this basis (the RVPINN loss ``r^T G^{-1} r``).
        The returned callable takes ``(n_inner, 1)`` or ``(n_inner,)``
        vectors and keeps the shape.

        * ``method="cholesky"`` factors the dense reduced Gram once; each
          application is a pair of triangular solves.
        * ``method="pcg"``: matrix-free PCG on the hybrid-ELL operator
          (``max_k=8``), O(nnz) memory, so the test space scales with the
          FEM side. It returns a :class:`GramPCG`: ``solve(r, x0=None)``,
          whose backward is one more PCG seeded with the rescaled forward
          solution; ``x0`` only sets the forward's starting point and
          carries no gradient.

        ``precondition`` (pcg): ``"two_level"`` builds the smoothed
        two-level M once here (``leaf=32, kp=4``) when the system has at
        least 256 unknowns, and point Jacobi below that; anything else
        keeps Jacobi. ``tol`` defaults to the working precision: 1e-12 in
        float64, 1e-6 in float32. ``maxiter`` defaults to max(10 n, 100).
        """
        if tol is None:
            tol = 1e-12 if torch.finfo(self.dtype).eps < 1e-10 else 1e-6
        if method == "cholesky":
            factor = torch.linalg.cholesky(
                self.reduce(self.integrate_bilinear_form(form))
            )

            def solve(r: torch.Tensor) -> torch.Tensor:
                if r.dim() == 1:
                    return torch.cholesky_solve(r[:, None], factor)[:, 0]
                return torch.cholesky_solve(r, factor)

            return solve
        if method != "pcg":
            raise ValueError(
                f"unknown gram_solver method: {method!r} "
                "(expected 'cholesky' or 'pcg')"
            )

        from ..ops.precondition import two_level_from_values
        from ..ops.sparse import (
            ell_diagonal,
            ell_matvec,
            ell_values_from_local,
            get_ell_structure,
        )

        structure = get_ell_structure(self, max_k=8)
        with torch.no_grad():
            values = ell_values_from_local(
                structure, self.integrate_bilinear_form_local(form)
            )
            diag = ell_diagonal(structure, values)
            n = structure.n_inner
            precond = None
            if precondition == "two_level" and n >= 256:
                # G is constant across applications: build the whole
                # two-level M once; every later solve, forward and
                # backward, reuses it
                tl = self._two_level_tables(structure)
                precond = two_level_from_values(tl, structure, values, diag)
        return GramPCG(
            lambda v: ell_matvec(structure, values, v),
            diag,
            precond,
            tol=tol,
            maxiter=maxiter if maxiter is not None else max(10 * n, 100),
        )

    def compiled_solver(self, bilinear_form, linear_form=None, **kwargs):
        """Assemble+solve pipeline for this basis (BSR path).

        Builds every host structure once and returns ``solve() -> (u,
        PCGInfo)``; see :func:`ops.compiled.compiled_bsr_solver` for options.
        """
        from ..ops.compiled import compiled_bsr_solver

        return compiled_bsr_solver(self, bilinear_form, linear_form, **kwargs)

    def compiled_refined(self, bilinear_form, linear_form=None, **kwargs):
        """Mixed-precision refined solve: float32 two-level PCG inner
        stages and float64 residuals, float64-grade answers from the
        float32 solver. Needs a float64 basis; the operator and rhs are
        assembled once, here. Returns ``solve(b=None) -> (u, RefineInfo)``;
        see :func:`ops.refine.compiled_refined_solver` for options."""
        from ..ops.refine import compiled_refined_solver

        return compiled_refined_solver(self, bilinear_form, linear_form, **kwargs)

    def compiled_eigsh(self, a_form, m_form, k: int = 6, **kwargs):
        """Generalized eigensolve on built tables: the counterpart of the
        JAX one-jit eigensolve (LOBPCG by default). Returns ``solve() ->
        (vals, vecs, (rounds, eig_change, converged))``; see
        :func:`ops.compiled.compiled_eigsh_solver` for options."""
        from ..ops.compiled import compiled_eigsh_solver

        return compiled_eigsh_solver(self, a_form, m_form, k, **kwargs)

    def solve_eigsh(
        self,
        a_form: Callable[..., torch.Tensor],
        m_form: Callable[..., torch.Tensor],
        k: int = 6,
        *,
        tol: float = 1e-9,
        max_rounds: int = 60,
        solve_tol: float = 1e-10,
        precondition: str = "two_level",
        seed: int = 0,
        return_info: bool = False,
        method: str = "subspace",
    ):
        """Smallest ``k`` eigenpairs of a(u, v) = λ m(u, v) on the interior
        (non-Dirichlet) DOFs, both forms symmetric positive definite there.

        On the BSR operators (K2): shift-invert subspace iteration
        (``ops.eigen.subspace_eigsh``, the default), whose inner A-solves
        run the preconditioned CG of :meth:`solve_iterative`, or
        ``method="lobpcg"`` (``ops.eigen.lobpcg_eigsh``, one preconditioner
        application per column per round, at least 200 rounds allowed).
        ``precondition``: ``"two_level"`` (``auto_preconditioner``) or
        ``"jacobi"``. The start block is NumPy's ``default_rng(seed)`` over
        ``(n_dofs, m)`` in float64, cast to the basis's dtype and reduced
        per column, m = ``min(k + max(2, k // 2), n_inner)``.

        Returns eigenvalues ascending and M-orthonormal eigenvectors as
        full DOF vectors (zeros on Dirichlet DOFs), ``(k,)`` and ``(n_dofs,
        k)``, and with ``return_info`` an ``EighInfo``. On the unit square
        the Dirichlet Laplace spectrum converges to π^2 (2, 5, 5, 8) at
        O(h^2).
        """
        from ..ops.bsr import (
            bsr_diagonal,
            bsr_expand,
            bsr_matvec,
            bsr_reduce,
            bsr_values_from_local,
            default_max_b,
            get_bsr_structure,
        )
        from ..ops.eigen import EighInfo, lobpcg_eigsh, subspace_eigsh

        if method not in ("subspace", "lobpcg"):
            raise ValueError(
                f"unknown method: {method!r} (expected 'subspace' or 'lobpcg')"
            )
        # validate before any assembly; the guard block must fit in the
        # reduced space too, or the projected Gram goes singular
        n_inner = int(self._basis_parameters["inner_dofs"].numel())
        if k > n_inner:
            raise ValueError(f"requested k={k} eigenpairs from an n={n_inner} system")
        m_block = min(k + max(2, k // 2), n_inner)

        structure = get_bsr_structure(self, max_b=default_max_b(self), want_entry_slot=True)
        va = bsr_values_from_local(structure, self.integrate_bilinear_form_local(a_form))
        vm = bsr_values_from_local(structure, self.integrate_bilinear_form_local(m_form))
        diag = bsr_diagonal(structure, va)
        precond = None
        if precondition == "two_level":
            from ..ops.precondition import auto_preconditioner

            precond = auto_preconditioner(self, structure, va, diag)
        elif precondition != "jacobi":
            raise ValueError(
                f"unknown precondition: {precondition!r} "
                "(expected 'two_level' or 'jacobi')"
            )

        # the start block in the padded reduced layout: random on interior
        # DOFs, exactly zero on padding rows
        rand = torch.as_tensor(
            np.random.default_rng(seed).standard_normal((self.n_dofs, m_block)),
            dtype=self.dtype, device=self.device,
        )
        x0 = torch.stack([bsr_reduce(structure, rand[:, j]) for j in range(m_block)], dim=1)

        def a_mv(v):
            return bsr_matvec(structure, va, v)

        def m_mv(v):
            return bsr_matvec(structure, vm, v)

        pdiag = None if precond is not None else diag
        if method == "lobpcg":
            vals, vecs_pad, (rounds, change, conv) = lobpcg_eigsh(
                a_mv, m_mv, x0, k, tol=tol, max_rounds=max(max_rounds, 200),
                precond=precond, precond_diag=pdiag,
            )
            info = EighInfo(iterations=rounds, eig_change=float(change), converged=bool(conv))
        else:
            vals, vecs_pad, info = subspace_eigsh(
                a_mv, m_mv, n=x0.shape[0], k=k, n_extra=m_block - k, tol=tol,
                max_rounds=max_rounds, solve_tol=solve_tol, precond=precond,
                precond_diag=pdiag, x0=x0, dtype=self.dtype,
            )
        vectors = torch.stack(
            [bsr_expand(structure, vecs_pad[:, j], self.n_dofs)[..., 0] for j in range(k)],
            dim=1,
        )
        if return_info:
            return vals, vectors, info
        return vals, vectors

    def compiled_newton(self, residual_form, **kwargs):
        """Newton solve on built tables: the counterpart of the JAX
        one-jit Newton (same residual-form contract as
        :meth:`solve_newton`). Returns ``solve(u0=None, *args) -> (u,
        (iterations, residual_norm, converged))``; see
        :func:`ops.compiled.compiled_newton_solver` for options."""
        from ..ops.compiled import compiled_newton_solver

        return compiled_newton_solver(self, residual_form, **kwargs)

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
        batch_size: Optional[int] = None,
    ) -> dict:
        """Shared scatter-index / interior-DOF construction.

        With ``batch_size`` set, shapes gain a leading batch axis and the
        scatter tuple a batch index (the fracture-edge basis); boundary
        markers must then be identical across the batch, since ``reduce``
        applies one interior-DOF list to every entry.
        """
        nb_local_dofs = int(global_dofs4elements.shape[-1])
        markers_all = self._as_host_index(nodes4boundary_dofs)
        if batch_size is not None:
            if not (markers_all == markers_all[:1]).all():
                raise NotImplementedError(
                    "batched bases require identical boundary markers across "
                    "the batch (reduce() applies one interior-DOF list)"
                )
            markers = markers_all[0].reshape(-1)
        else:
            markers = markers_all.reshape(-1)
        device = global_dofs4elements.device
        inner_dofs = torch.as_tensor(
            np.nonzero(markers != 1)[0].astype(np.int32),
            dtype=config.index_dtype(),
            device=device,
        )
        dofs = global_dofs4elements
        if batch_size is None:
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
        batch_idx = torch.arange(
            batch_size, dtype=config.index_dtype(), device=device
        )[:, None]
        rows_idx = torch.repeat_interleave(dofs, nb_local_dofs, dim=-1).reshape(
            batch_size, -1
        )
        cols_idx = dofs.repeat(1, 1, nb_local_dofs).reshape(batch_size, -1)
        return {
            "bilinear_form_shape": (batch_size, nb_global_dofs, nb_global_dofs),
            "bilinear_form_idx": (batch_idx, rows_idx, cols_idx),
            "linear_form_shape": (batch_size, nb_global_dofs, 1),
            "linear_form_idx": (batch_idx, dofs.reshape(batch_size, -1)),
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


class _GramPCGFunction(torch.autograd.Function):
    """``x = G^{-1} r`` by PCG from ``x0``; the backward is one more PCG.

    G is SPD and constant, so the pullback of a cotangent ``c`` is
    ``G^{-1} c``. It starts from ``a x`` with ``a = <c, x> / <r, x>`` (0
    when ``<r, x> = 0``): for the RVPINN loss ``r^T G^{-1} r`` the
    cotangent is parallel to ``r``, so ``a x`` is already the answer and
    the backward PCG exits in O(1) iterations. ``x0`` gets no gradient.
    """

    @staticmethod
    def forward(ctx, r, x0, gram):
        x = gram.run(r.reshape(-1), x0.reshape(-1), "forward").reshape(r.shape)
        ctx.save_for_backward(r, x)
        ctx.gram = gram
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, cotangent):
        r, x = ctx.saved_tensors
        xf, cf = x.reshape(-1), cotangent.reshape(-1)
        denom = torch.dot(r.reshape(-1), xf)  # x^T G x >= 0, 0 only if x == 0
        zero = denom == 0
        a = torch.where(
            zero, torch.zeros_like(denom),
            torch.dot(cf, xf) / torch.where(zero, torch.ones_like(denom), denom),
        )
        y = ctx.gram.run(cf, a * xf, "backward")
        return y.reshape(cotangent.shape), None, None


class GramPCG:
    """``solve(r, x0=None) -> G^{-1} r`` by matrix-free PCG, differentiable
    in ``r`` (``gram_solver(method="pcg")``).

    ``iterations`` records the PCG iteration count of every forward and
    every backward solve, in call order (``{"forward": [...], "backward":
    [...]}``); clear the lists to start a new count.
    """

    def __init__(self, matvec, diag, precond, *, tol: float, maxiter: int):
        self.matvec = matvec
        self.diag = diag
        self.precond = precond
        self.tol = tol
        self.maxiter = maxiter
        self.iterations = {"forward": [], "backward": []}

    def run(self, b: torch.Tensor, x0: torch.Tensor, direction: str) -> torch.Tensor:
        """One PCG solve of ``G x = b`` from ``x0`` (no autograd)."""
        from ..ops.solvers import pcg

        x, info = pcg(
            self.matvec,
            b,
            x0=x0,
            precond=self.precond,
            precond_diag=None if self.precond is not None else self.diag,
            tol=self.tol,
            maxiter=self.maxiter,
        )
        self.iterations[direction].append(info.iterations)
        return x

    def __call__(self, r: torch.Tensor, x0: Optional[torch.Tensor] = None) -> torch.Tensor:
        if x0 is None:
            x0 = torch.zeros_like(r)
        return _GramPCGFunction.apply(r, x0.detach(), self)
