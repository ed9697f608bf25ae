"""Multi-process scaling over a ``torch.distributed`` process group.

Counterpart of ``pytorch_fem_solver_tpu/parallel``: the cell-sharded
Jacobi PCG (matrix-free and hybrid ELL), the cell-sharded basis, and the
row-sharded BSR assemble+solve with its shard plan. The sharded Newton,
eigen and Stokes solvers are still to be ported (ROADMAP.md, A9c).
"""

from .sharded_bsr import (
    get_bsr_shard_plan,
    sharded_bsr_solver,
    solve_pcg_sharded_bsr,
)
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
    "make_device_mesh",
    "shard_basis_cells",
    "solve_pcg_sharded",
    "solve_pcg_sharded_bsr",
    "solve_pcg_sharded_ell",
]
