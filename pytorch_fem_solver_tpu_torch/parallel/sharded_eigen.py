"""Row-sharded generalized eigensolve: the multi-process twin of
``ops.compiled.compiled_eigsh_solver`` (LOBPCG).

Counterpart of ``pytorch_fem_solver_tpu/parallel/sharded_eigen.py``. A
LOBPCG round is one A-block product, one M-block product and one
preconditioner application, each row-sharded with one all-gather of its
column per product (K2 on the rank's block rows), plus a few small Gram
matrices (at most 3m x 3m) and column norms, which are per-rank partial
products summed by an all-reduce (the ``psum`` hook of
``ops.eigen.lobpcg_eigsh``). The small eigendecompositions are computed on
every rank from the same sums, so every rank takes the same locking and
stopping decisions. Both forms assemble on the rank's halo cells, with no
collective.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..ops.compiled import _mm_precision
from ..ops.eigen import lobpcg_eigsh
from .sharded_bsr import (
    _all_gather,
    _check_precondition,
    _halo_view,
    _psum,
    _scatter_local_values,
    _shard_jacobi_precond,
    _shard_matvec,
    _shard_tables,
    _shard_two_level_precond,
    get_bsr_shard_plan,
)
from .sharding import _default_mesh, _group

__all__ = ["sharded_eigsh_solver"]


def sharded_eigsh_solver(
    basis,
    a_form: Callable,
    m_form: Callable,
    k: int = 6,
    *,
    device_mesh=None,
    tol: float = 1e-9,
    max_rounds: int = 200,
    precondition: str = "two_level",
    seed: int = 0,
    max_b: Optional[int] = None,
    lock_tol: Optional[float] = None,
    matmul_precision: Optional[str] = "highest",
):
    """The smallest ``k`` pairs of the SPD pencil (A, M) on the interior
    DOFs, with cells and block rows sharded over the process group.

    Same contract and stopping rule as
    :func:`ops.compiled.compiled_eigsh_solver` with ``method="lobpcg"``
    (``max_rounds=max(max_rounds, 200)``); every rank calls it with the same
    basis. ``precondition`` is ``"two_level"``/``"auto"`` (the per-rank
    aggregate-block M with the row-sharded coarse apply) or ``"jacobi"``.
    The start block is drawn as the single-process path draws it, NumPy's
    ``default_rng(seed)`` over ``(n_dofs, m)`` permuted into the padded
    layout, so the same seed gives the same block and the same rounds.

    Returns ``solve() -> (vals (k,), vecs (n_dofs, k), (rounds, eig_change,
    converged))``: the same on every rank, ``rounds`` a Python int, the
    other two 0-dim tensors.
    """
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    _check_precondition(precondition)
    device_mesh = _default_mesh(device_mesh)
    group, rank, n_shards = _group(device_mesh)
    plan = get_bsr_shard_plan(basis, n_shards, max_b=max_b)
    st = plan.st
    lrows = plan.rps * st.block
    n_dofs = int(basis.n_dofs)
    n_inner = st.n_inner
    if k > n_inner:
        raise ValueError(f"requested k={k} eigenpairs from an n={n_inner} system")
    m_block = min(k + max(2, k // 2), n_inner)

    tables = _shard_tables(plan, rank, basis.device)
    view, dx = _halo_view(basis, tables)
    inner_perm = np.asarray(st.inner_perm)
    # the start block: the full-DOF normal block permuted into the padded
    # reduced layout (zero on padding rows), this rank's rows
    rand = np.random.default_rng(seed).standard_normal((n_dofs, m_block))
    x0_host = np.zeros((plan.nb_pad * st.block, m_block), dtype=np.float64)
    x0_host[:n_inner] = rand[inner_perm]
    x0 = torch.as_tensor(x0_host[rank * lrows:(rank + 1) * lrows], device=basis.device).to(
        basis.dtype)
    inner_perm = torch.as_tensor(inner_perm, dtype=torch.int64, device=basis.device)
    psum = _psum(group)

    def _run():
        local_a = (basis._evaluate_form(a_form, view) * dx).sum(-3)
        local_m = (basis._evaluate_form(m_form, view) * dx).sum(-3)
        v1a, v2a, diag_a = _scatter_local_values(plan, local_a, tables)
        v1m, v2m, _ = _scatter_local_values(plan, local_m, tables)
        if precondition in ("auto", "two_level"):
            precond = _shard_two_level_precond(plan, group, rank, v1a, v2a, tables)
        else:
            precond = _shard_jacobi_precond(diag_a)
        vals, vecs_local, info = lobpcg_eigsh(
            _shard_matvec(plan, group, v1a, v2a, tables),
            _shard_matvec(plan, group, v1m, v2m, tables),
            x0, k, tol=tol,
            # the compiled solver's LOBPCG floor: a small max_rounds means
            # the same on both
            max_rounds=max(max_rounds, 200), precond=precond, lock_tol=lock_tol, psum=psum,
        )
        vecs_full = _all_gather(vecs_local, group, n_shards)
        vecs = vecs_full.new_zeros((n_dofs, k)).index_copy(0, inner_perm, vecs_full[:n_inner])
        return vals, vecs, info

    def solve():
        with _mm_precision(matmul_precision):
            return _run()

    return solve
