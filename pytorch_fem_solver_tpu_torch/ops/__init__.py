"""Device operators: element kernels, BSR and ELL assembly and SpMV, the
two- and three-level preconditioners (aggregate-block, block-Jacobi,
multiplicative, smoothed, affine / rigid-body-mode, ELL), the Krylov
solvers and the assemble+solve pipelines.

``__all__`` is the JAX package's."""

from .bsr import (
    bsr_diagonal,
    bsr_expand,
    bsr_matvec,
    bsr_reduce,
    bsr_values_from_local,
    bsr_values_from_local_symmetric,
    build_bsr_structure,
    get_bsr_structure,
)
from .compiled import (
    compiled_bsr_solver,
    compiled_eigsh_solver,
    compiled_newton_solver,
    compiled_stokes_solver,
)
from .eigen import subspace_eigsh
from .operators import local_matvec, operator_diagonal, reduced_operator_from_local
from .precondition import (
    affine_two_level_from_values,
    auto_preconditioner,
    batched_small_inv,
    block_two_level_from_values,
    build_affine_two_level_structure,
    build_smoothed_two_level,
    build_three_level_structure,
    build_two_level,
    build_two_level_structure,
    default_aggregate_size,
    get_affine_two_level_structure,
    get_three_level_structure,
    mult_three_level_from_values,
    mult_two_level_from_values,
    smoothed_two_level_matrix_free,
    spatial_aggregates,
    three_level_from_values,
    two_level_from_values,
)
from .refine import RefineInfo, compiled_refined_solver
from .saddle import stokes_solver
from .solvers import bicgstab, cg, dense_solve, pcg
from .sparse import (
    build_ell_structure,
    ell_diagonal,
    ell_matvec,
    ell_values_from_local,
    get_ell_structure,
    invert_scatter_map,
    reduced_ell_operator,
)

__all__ = [
    "RefineInfo",
    "compiled_bsr_solver",
    "compiled_eigsh_solver",
    "compiled_newton_solver",
    "compiled_refined_solver",
    "compiled_stokes_solver",
    "stokes_solver",
    "local_matvec",
    "operator_diagonal",
    "reduced_operator_from_local",
    "bicgstab",
    "subspace_eigsh",
    "cg",
    "dense_solve",
    "pcg",
    "build_ell_structure",
    "ell_diagonal",
    "ell_matvec",
    "ell_values_from_local",
    "get_ell_structure",
    "invert_scatter_map",
    "reduced_ell_operator",
    "build_smoothed_two_level",
    "build_two_level",
    "build_two_level_structure",
    "spatial_aggregates",
    "two_level_from_values",
    "build_bsr_structure",
    "bsr_diagonal",
    "bsr_expand",
    "bsr_matvec",
    "bsr_reduce",
    "bsr_values_from_local",
    "bsr_values_from_local_symmetric",
    "get_bsr_structure",
    "block_two_level_from_values",
    "batched_small_inv",
    "default_aggregate_size",
    "smoothed_two_level_matrix_free",
    "auto_preconditioner",
    "mult_two_level_from_values",
    "mult_three_level_from_values",
    "get_three_level_structure",
    "get_affine_two_level_structure",
    "build_affine_two_level_structure",
    "affine_two_level_from_values",
    "build_three_level_structure",
    "three_level_from_values",
]
