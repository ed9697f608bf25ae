"""Matrix-free FEM operators: gather -> local matvec -> segment-sum.

Counterpart of ``pytorch_fem_solver_tpu/ops/operators.py``. The global
stiffness action A @ x is computed from unassembled element matrices as

    x_loc = x[dofs]                      # gather            (T, n_loc)
    y_loc = local_matrices @ x_loc       # batched tiny matmul (T, n_loc)
    y     = index_add(y_loc, dofs, n)    # scatter-add

with O(T * n_loc^2) memory and no assembled matrix. This is the
``method="segment"`` operator of ``solve_iterative``.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def local_matvec(local_matrices, dofs, n_dofs: int, x):
    """Action of the assembled operator on a full DOF vector x (n,)."""
    y_loc = torch.einsum("...tij,...tj->...ti", local_matrices, x[dofs])
    return x.new_zeros(n_dofs).index_add(0, dofs.reshape(-1), y_loc.reshape(-1))


def operator_diagonal(local_matrices, dofs, n_dofs: int):
    """Diagonal of the assembled operator (Jacobi preconditioner)."""
    diag_loc = torch.diagonal(local_matrices, dim1=-2, dim2=-1)
    return diag_loc.new_zeros(n_dofs).index_add(
        0, dofs.reshape(-1), diag_loc.reshape(-1)
    )


def reduced_operator_from_local(
    basis, local_matrices
) -> Tuple[Callable[[torch.Tensor], torch.Tensor], torch.Tensor]:
    """Matrix-free operator restricted to interior DOFs.

    The reduced vector is scattered into a full vector (zeros on boundary
    DOFs), the full operator applied, and the interior entries gathered
    back. Returns ``(matvec, jacobi_diagonal)``; ``matvec`` maps
    (n_inner,) -> (n_inner,).
    """
    n_loc = basis._global_dofs4elements.shape[-1]
    # flatten any leading batch axes (fracture bases carry (B*T, n_loc) DOF
    # maps against (B, T, n_loc, n_loc) local matrices)
    dofs = basis._global_dofs4elements.reshape(-1, n_loc)
    local_matrices = local_matrices.reshape(-1, n_loc, n_loc)
    n = basis.n_dofs
    inner = basis._basis_parameters["inner_dofs"].long()

    def matvec(x_reduced):
        x_full = x_reduced.new_zeros(n).index_copy(0, inner, x_reduced)
        return local_matvec(local_matrices, dofs, n, x_full)[inner]

    diag = operator_diagonal(local_matrices, dofs, n)[inner]
    return matvec, diag
