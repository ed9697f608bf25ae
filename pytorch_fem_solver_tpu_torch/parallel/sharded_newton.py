"""Row-sharded Newton solve: the multi-process twin of
``ops.compiled.compiled_newton_solver``.

Counterpart of ``pytorch_fem_solver_tpu/parallel/sharded_newton.py``. Each
rank of the process group runs the same Newton loop on its slices of the
shard plan (``sharded_bsr.BSRShardPlan``):

  residual        the residual form on the rank's halo cells, scattered into
                  the reduced rows the rank owns (``vec_slots``: every real
                  entry lands on exactly one rank, with no collective); the
                  norm is one all-reduced dot
  Jacobian        one ``torch.func.jvp`` per local DOF on the same halo
                  cells, into the rank's BSR value slice, as the linear
                  sharded path scatters its element matrices
  update solve    BiCGStab (``ops.solvers.bicgstab`` with the group-summed
                  dot) on the row-sharded operator (one all-gather of the
                  iterate per product, then K2 on the rank's block rows),
                  with Jacobi or the per-rank aggregate-block two-level M
  damping         halvings of the step judged on the all-reduced residual
                  norm, the compiled solver's rule

The iterate ``u`` is replicated on every rank (O(n), as the gathered search
direction); the values, the smoother blocks and the coarse rows are per
rank. Every branch reads a value that was all-reduced or all-gathered, so
all ranks take it alike.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from ..basis.abstract_basis import AbstractBasis
from ..ops.bsr import _scatter_drop
from ..ops.compiled import _CellChunkView, _mm_precision
from ..ops.solvers import bicgstab
from .sharded_bsr import (
    _all_gather,
    _check_precondition,
    _pdot,
    _scatter_local_values,
    _shard_jacobi_precond,
    _shard_matvec,
    _shard_tables,
    _shard_two_level_precond,
    get_bsr_shard_plan,
)
from .sharding import _default_mesh, _group

__all__ = ["sharded_newton_solver"]


class _HaloCellView(_CellChunkView):
    """The rank's halo cells of a basis with the quadrature-iterate hook
    Newton differentiates through (``AbstractBasis``'s own: it reads only
    ``v``, ``v_grad`` and ``n_components``)."""

    _iterate_at_quadrature = AbstractBasis._iterate_at_quadrature
    _evaluate_form = AbstractBasis.__dict__["_evaluate_form"]

    def __init__(self, v, v_grad, integration_points, dx, element, n_components=1):
        super().__init__(v, v_grad, integration_points, dx, element)
        self.n_components = n_components


def sharded_newton_solver(
    basis,
    residual_form: Callable,
    *,
    device_mesh=None,
    tol: float = 1e-10,
    max_newton: int = 25,
    solve_tol: float = 1e-8,
    solve_maxiter: Optional[int] = None,
    precondition: str = "jacobi",
    damping: bool = True,
    max_b: Optional[int] = None,
    matmul_precision: Optional[str] = "highest",
):
    """Newton's method for F(u)[v] = 0 with cells and block rows sharded
    over the process group.

    Same ``residual_form(basis, u, u_grad)`` contract, stopping rule (the
    relative norm of the reduced residual), damping rule and return
    convention as :func:`ops.compiled.compiled_newton_solver`; every rank
    calls it with the same basis. ``precondition`` is ``"jacobi"`` (the
    default, robust on the non-symmetric linearisation) or
    ``"auto"``/``"two_level"`` (the per-rank aggregate-block two-level M
    rebuilt from each step's Jacobian values). Extra ``residual_form``
    arguments are not taken (they would need halo gathering): close over
    tensors instead. ``solve_maxiter`` defaults to ``max(10 nb_pad k,
    100)``.

    Returns ``solve(u0=None) -> (u (n_dofs, 1), (iterations, residual_norm,
    converged))``: the same ``u`` on every rank, ``iterations`` a Python
    int, the other two 0-dim tensors.
    """
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    _check_precondition(precondition)
    device_mesh = _default_mesh(device_mesh)
    group, rank, n_shards = _group(device_mesh)
    plan = get_bsr_shard_plan(basis, n_shards, max_b=max_b)
    st = plan.st
    lrows = plan.rps * st.block
    n_dofs = int(basis.n_dofs)
    n_loc = int(basis._global_dofs4elements.shape[-1])
    if solve_maxiter is None:
        solve_maxiter = max(10 * plan.nb_pad * st.block, 100)

    tables = _shard_tables(plan, rank, basis.device)
    cells = tables.cells
    dx = basis._dx[cells]
    view = _HaloCellView(basis.v, basis.v_grad[cells], basis.integration_points[cells], dx,
                         basis._element, int(getattr(basis, "n_components", 1)))
    dofs = basis._global_dofs4elements.reshape(-1, n_loc)[cells].long()
    inner_perm = torch.as_tensor(st.inner_perm, dtype=torch.int64, device=basis.device)
    n_inner = st.n_inner
    pdot = _pdot(group)
    two_level = precondition in ("auto", "two_level")

    def residual_local(u_cells):
        uh, ugh = view._iterate_at_quadrature(u_cells)
        return (view._evaluate_form(residual_form, view, uh, ugh) * dx).sum(-3)

    def res_norm(u):
        """The all-reduced norm of the reduced residual: the halo cells'
        vectors scattered into the owned rows."""
        r = _scatter_drop(tables.vec_slots, residual_local(u[dofs]).reshape(-1), lrows)
        return torch.sqrt(pdot(r, r))

    def newton_terms(u_cells):
        """The owned rows of the residual and the consistent Jacobian's
        element matrices on the halo cells: column j is the jvp against the
        one-hot tangent of local DOF j."""
        r_local, cols = None, []
        for j in range(n_loc):
            tangent = torch.zeros_like(u_cells)
            tangent[..., j] = 1.0
            primal, col = torch.func.jvp(residual_local, (u_cells,), (tangent,))
            r_local = primal if r_local is None else r_local
            cols.append(col)
        return _scatter_drop(tables.vec_slots, r_local.reshape(-1), lrows), torch.cat(cols, -1)

    def update(u):
        """The BiCGStab update of one step, the whole (n_dofs,) vector."""
        r, j_local = newton_terms(u[dofs])
        v1, v2, diag_local = _scatter_local_values(plan, j_local, tables)
        if two_level:
            precond = _shard_two_level_precond(plan, group, rank, v1, v2, tables)
        else:
            precond = _shard_jacobi_precond(diag_local)
        x, _ = bicgstab(_shard_matvec(plan, group, v1, v2, tables), -r, precond=precond,
                        tol=solve_tol, maxiter=solve_maxiter, dot=pdot)
        x_full = _all_gather(x, group, n_shards)
        return u.new_zeros(n_dofs).index_copy(0, inner_perm, x_full[:n_inner])

    def _run(u):
        res = res_norm(u)
        target = tol * torch.clamp(res, min=1.0)
        res_h, target_h = (float(v) for v in torch.stack([res, target]).cpu())
        k = 0
        while res_h > target_h and k < max_newton:
            delta = update(u)
            step, halvings = 1.0, 0
            rn = res_norm(u + step * delta)
            rn_h = float(rn)
            # not (rn < res): a NaN trial norm keeps damping
            while damping and not rn_h < res_h and halvings < 12:
                step *= 0.5
                rn = res_norm(u + step * delta)
                rn_h = float(rn)
                halvings += 1
            if not math.isfinite(rn_h) or (damping and rn_h >= res_h):
                k = max_newton  # a stall: the iterate stays
            else:
                u = u + step * delta
                res, res_h = rn, rn_h
                k += 1
        return u[:, None], (k, res, res <= target)

    def solve(u0=None):
        if u0 is None:
            u0 = basis.solution_tensor()
        with _mm_precision(matmul_precision):
            return _run(u0[..., 0])

    return solve
