"""Multi-process scaling over a ``torch.distributed`` process group.

Counterpart of ``pytorch_fem_solver_tpu/parallel``: the cell-sharded
Jacobi PCG (matrix-free and hybrid ELL), the cell-sharded basis, the
row-sharded BSR assemble+solve with its shard plan, and the row-sharded
Newton, LOBPCG eigen and Stokes solvers built on that plan.
"""

from .sharded_bsr import (
    get_bsr_shard_plan,
    sharded_bsr_solver,
    solve_pcg_sharded_bsr,
)
from .sharded_eigen import sharded_eigsh_solver
from .sharded_newton import sharded_newton_solver
from .sharded_stokes import sharded_stokes_solver
from .sharding import (
    CELL_AXIS,
    make_device_mesh,
    shard_basis_cells,
    solve_pcg_sharded,
    solve_pcg_sharded_ell,
)

__all__ = [
    "CELL_AXIS",
    "get_bsr_shard_plan",
    "sharded_bsr_solver",
    "sharded_eigsh_solver",
    "sharded_newton_solver",
    "sharded_stokes_solver",
    "make_device_mesh",
    "shard_basis_cells",
    "solve_pcg_sharded",
    "solve_pcg_sharded_bsr",
    "solve_pcg_sharded_ell",
]
