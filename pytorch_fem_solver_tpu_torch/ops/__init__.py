"""Device operators: element kernels, BSR and ELL assembly and SpMV, the
aggregate-block and ELL two-level preconditioners, the Krylov solvers and
the assemble+solve pipeline.

``__all__`` is the JAX package's less what is still queued in ROADMAP.md:
the three-level and multiplicative preconditioner families and the
smoothed matrix-free two-level M (A6), and the refined, eigen and Stokes
solvers (A5)."""

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
from .compiled import compiled_bsr_solver, compiled_newton_solver
from .operators import local_matvec, operator_diagonal, reduced_operator_from_local
from .precondition import (
    affine_two_level_from_values,
    auto_preconditioner,
    batched_small_inv,
    block_two_level_from_values,
    build_affine_two_level_structure,
    build_two_level,
    build_two_level_structure,
    default_aggregate_size,
    get_affine_two_level_structure,
    spatial_aggregates,
    two_level_from_values,
)
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
    "compiled_bsr_solver",
    "compiled_newton_solver",
    "local_matvec",
    "operator_diagonal",
    "reduced_operator_from_local",
    "bicgstab",
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
    "auto_preconditioner",
    "get_affine_two_level_structure",
    "build_affine_two_level_structure",
    "affine_two_level_from_values",
]
