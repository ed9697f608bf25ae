"""Row-sharded Stokes solve: the multi-process twin of
``ops.compiled.compiled_stokes_solver`` (the Schur method).

Counterpart of ``pytorch_fem_solver_tpu/parallel/sharded_stokes.py``. Each
rank runs the nested Schur-complement CG on its slices of the velocity
basis's shard plan:

  A block       the halo cells' viscous element matrices in the rank's BSR
                value slice; inner PCG (``ops.solvers.pcg`` with the
                group-summed dot) on the row-sharded operator (one
                all-gather per product, then K2 on the rank's block rows)
                with Jacobi or the per-rank aggregate-block two-level M
  B^T p         the mixed element blocks on the halo cells, scattered into
                the rank's own reduced velocity rows (``vec_slots``:
                exactly once, no collective), the layout the inner solve
                takes
  B u           the partials of the cells the rank owns (``owned``: each
                real cell on exactly one rank) and one all-reduce of the
                (n_p,) vector per application
  outer CG      ``ops.saddle.schur_flexible_cg``; the pressure vectors are
                replicated (n_p << n_u), so the lumped-mass preconditioner,
                the mean projection and the outer dots are the same
                computation on every rank

Per outer iteration: the inner PCG's all-gathers and dots, one (n_p,)
all-reduce and one all-gather of the velocity.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from ..ops.bsr import _scatter_drop
from ..ops.compiled import _mm_precision
from ..ops.saddle import StokesInfo, lumped_mass, schur_flexible_cg
from ..ops.solvers import pcg
from .sharded_bsr import (
    _all_gather,
    _check_precondition,
    _halo_view,
    _pdot,
    _scatter_local_values,
    _shard_jacobi_precond,
    _shard_matvec,
    _shard_tables,
    _shard_two_level_precond,
    get_bsr_shard_plan,
)
from .sharding import _default_mesh, _group

__all__ = ["sharded_stokes_solver"]


def sharded_stokes_solver(
    velocity_basis,
    pressure_basis,
    a_form: Callable,
    b_form: Callable,
    *,
    device_mesh=None,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    inner_tol: float = 1e-11,
    inner_maxiter: Optional[int] = None,
    precondition: str = "jacobi",
    mass_form: Optional[Callable] = None,
    max_b: Optional[int] = None,
    matmul_precision: Optional[str] = "highest",
    inner_eta: float = 0.1,
    inner_tol_max: float = 1e-2,
    f_solve_tol: Optional[float] = None,
    recovery_tol: Optional[float] = None,
    inner_iters: Optional[int] = None,
):
    """The Stokes saddle system with cells and velocity block rows sharded
    over the process group.

    Same forms contract, stopping rule (the lumped-M_p-preconditioned Schur
    residual), keywords and return convention as
    :func:`ops.compiled.compiled_stokes_solver` with ``method="schur"``;
    every rank calls it with the same bases. ``precondition`` is
    ``"jacobi"`` (the default) or ``"two_level"``/``"auto"`` (the per-rank
    aggregate-block smoother with the constants coarse space: algebraic, so
    it takes the vector A block too, with more inner iterations than the
    single-process rigid-body-mode M). ``inner_iters`` runs every Schur
    apply's inner solve for exactly that many PCG iterations.

    Returns ``solve(f, g=None, x0=None) -> (u (n_u, 1), p (n_p, 1),
    StokesInfo)``, the same on every rank; the pressure has zero
    lumped-mass mean, ``outer_iterations`` and ``inner_total`` are ints.
    """
    _mm_precision(matmul_precision)  # an unknown name raises here, before any table
    _check_precondition(precondition)
    device_mesh = _default_mesh(device_mesh)
    group, rank, n_shards = _group(device_mesh)
    Vu, Vp = velocity_basis, pressure_basis
    plan = get_bsr_shard_plan(Vu, n_shards, max_b=max_b)
    st = plan.st
    lrows = plan.rps * st.block
    n_pad = plan.nb_pad * st.block
    n_u, n_p = int(Vu.n_dofs), int(Vp.n_dofs)
    n_loc_u = int(Vu._global_dofs4elements.shape[-1])
    n_loc_p = int(Vp._global_dofs4elements.shape[-1])
    if inner_maxiter is None:
        inner_maxiter = max(10 * plan.nb_pad * st.block, 100)
    outer_cap = maxiter if maxiter is not None else 10 * n_p

    # the rank's halo cells: the viscous form's view, the two DOF tables
    # and the mixed coupling blocks (geometry only, built once)
    tables = _shard_tables(plan, rank, Vu.device)
    cells = tables.cells
    view, dx = _halo_view(Vu, tables)
    u_dofs = Vu._global_dofs4elements.reshape(-1, n_loc_u)[cells].long()
    p_dofs = Vp._global_dofs4elements.reshape(-1, n_loc_p)[cells].long()
    p_dofs_flat = p_dofs.reshape(-1)
    local_b = Vp.integrate_mixed_bilinear_form_local(Vu, b_form).reshape(
        -1, n_loc_p, n_loc_u)[cells]
    owned = tables.owned[:, None]
    mp = lumped_mass(Vp, mass_form)[:, 0]
    mp_total = mp.sum()
    inv_lump = 1.0 / mp
    inner_perm = torch.as_tensor(st.inner_perm, dtype=torch.int64, device=Vu.device)
    n_inner = st.n_inner
    pdot = _pdot(group)

    def expand(x_local):
        """The rank's reduced rows -> the whole (n_u,) velocity (zero at
        Dirichlet rows): one all-gather and the permutation scatter."""
        x_full = _all_gather(x_local, group, n_shards)
        return x_full.new_zeros(n_u).index_copy(0, inner_perm, x_full[:n_inner])

    def reduce_rows(v_full):
        """(n_u,) -> the rank's rows of the permuted padded inner vector."""
        padded = torch.nn.functional.pad(v_full[inner_perm], (0, n_pad - n_inner))
        return padded[rank * lrows:(rank + 1) * lrows]

    def apply_b(u_full):
        """B u, replicated (n_p,): the owned cells' partials and one
        all-reduce."""
        pb = torch.einsum("tpi,ti->tp", local_b, u_full[u_dofs])
        pb = torch.where(owned, pb, torch.zeros_like(pb))
        partial = u_full.new_zeros(n_p).index_add_(0, p_dofs_flat, pb.reshape(-1))
        dist.all_reduce(partial, group=group)
        return partial

    def apply_bt_local(p_full):
        """B^T p in the rank's reduced rows (the vec_slots scatter, no
        collective)."""
        ub = torch.einsum("tpi,tp->ti", local_b, p_full[p_dofs])
        return _scatter_drop(tables.vec_slots, ub.reshape(-1), lrows)

    def project_mean(p_vec):
        return p_vec - (mp * p_vec).sum() / mp_total

    def _run(f, g, x0):
        local_a = (Vu._evaluate_form(a_form, view) * dx).sum(-3)
        v1, v2, diag_local = _scatter_local_values(plan, local_a, tables)
        matvec = _shard_matvec(plan, group, v1, v2, tables)
        if precondition in ("auto", "two_level"):
            precond = _shard_two_level_precond(plan, group, rank, v1, v2, tables)
        else:
            precond = _shard_jacobi_precond(diag_local)

        def solve_a_local(rhs_local, x0_local, tol_inner, maxiter_inner=inner_maxiter):
            return pcg(matvec, rhs_local, x0=x0_local, precond=precond, tol=tol_inner,
                       maxiter=maxiter_inner, dot=pdot)

        if inner_iters is None:
            solve_a_schur = solve_a_local
        else:
            # fixed-iteration inexact applies: tol 0 runs exactly inner_iters steps
            def solve_a_schur(rhs_local, x0_local, tol_inner):
                return solve_a_local(rhs_local, x0_local, 0.0, inner_iters)

        zeros_local = f.new_zeros(lrows)
        f_local = reduce_rows(f)
        u_f_local, info_f = solve_a_local(
            f_local, zeros_local, f_solve_tol if f_solve_tol is not None else inner_tol)
        rhs_p = project_mean(apply_b(expand(u_f_local)) - g)
        p_flat, res_fin, k_out, atol, inner_schur, u_bt = schur_flexible_cg(
            rhs_p,
            x0,
            apply_bt_w=apply_bt_local,
            solve_a=solve_a_schur,
            schur_out=lambda y: project_mean(apply_b(expand(y))),
            precond_p=lambda r: project_mean(inv_lump * r),
            dot_w=pdot,
            zeros_red=zeros_local,
            tol=tol,
            inner_tol=inner_tol,
            inner_eta=inner_eta,
            inner_tol_max=inner_tol_max,
            outer_cap=outer_cap,
        )
        p = project_mean(p_flat)
        # the velocity recovery, warm-started from the outer CG's free
        # by-product u_f - u_bt ~ A^{-1}(f - B^T p)
        u_local, info_u = solve_a_local(
            f_local - apply_bt_local(p), u_f_local - u_bt,
            recovery_tol if recovery_tol is not None else inner_tol)
        info = StokesInfo(
            outer_iterations=k_out,
            schur_residual=res_fin,
            converged=res_fin <= atol,
            inner_info=info_u,
            inner_total=info_f.iterations + inner_schur + info_u.iterations,
        )
        return expand(u_local)[:, None], p[:, None], info

    zero_p = Vp.solution_tensor()[:, 0]

    def solve(f, g=None, x0=None):
        with _mm_precision(matmul_precision):
            return _run(f[:, 0], zero_p if g is None else g[:, 0],
                        zero_p if x0 is None else x0[:, 0])

    return solve
