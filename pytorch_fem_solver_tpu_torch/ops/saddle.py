"""Matrix-free saddle-point (Stokes-type) solver: Schur-complement CG.

Counterpart of ``pytorch_fem_solver_tpu/ops/saddle.py``. It solves

    [A  B^T] [u]   [f]
    [B   0 ] [p] = [g]

without assembling a global matrix: A (the viscous block, SPD on the
Dirichlet-reduced velocity space) acts through the BSR operator and its
SpMV kernel K2; B and B^T act through the unassembled two-space element
matrices (``AbstractBasis.integrate_mixed_bilinear_form_local``: gather the
trial DOFs, a local matvec, scatter to the test DOFs). The pressure solve is
CG on the Schur complement S = B A^{-1} B^T, each application one inner
A-solve, preconditioned by the inverse lumped pressure mass (spectrally
equivalent to S for Stokes), with the constant pressure mode removed by a
mean projection in the lumped-mass inner product (no pinned DOF).

``schur_flexible_cg`` is the outer loop of
``ops.compiled.compiled_stokes_solver``: the JAX ``lax.while_loop`` becomes
a host loop that reads its four-part condition once per outer iteration,
as one stacked tensor, around inner PCG solves that read theirs once per
iteration. ``StokesInfo.outer_iterations`` and ``inner_total`` are ints.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from .solvers import PCGInfo, pcg

__all__ = ["StokesInfo", "schur_flexible_cg", "stokes_solver"]


class StokesInfo(NamedTuple):
    outer_iterations: int
    schur_residual: torch.Tensor
    converged: torch.Tensor
    inner_info: PCGInfo  # from the final velocity solve
    # total inner A-solve PCG iterations across the whole solve (initial
    # f-solve + every Schur application + the velocity recovery); None on
    # paths that do not account them (eager solver, minres)
    inner_total: Optional[int] = None


def schur_flexible_cg(
    rhs_p,
    x0,
    *,
    apply_bt_w: Callable,
    solve_a: Callable,
    schur_out: Callable,
    precond_p: Callable,
    dot_w: Callable,
    zeros_red,
    tol: float,
    inner_tol: float,
    inner_eta: float,
    inner_tol_max: float,
    outer_cap: int,
    stall_patience: int = 10,
):
    """Flexible outer CG on the Schur complement with warm-started,
    tolerance-relaxed inner A-solves (the JAX package's, step for step).

    1. Warm start: each inner solve starts from the previous inner
       solution scaled by ``gamma = <w_k, w_{k-1}> / <w_{k-1}, w_{k-1}>``
       (0 on the first apply, where ``w_{k-1} = 0``).
    2. Relaxed tolerance (van den Eshof & Sleijpen): the inner tolerance
       ``tol_k = inner_eta * tol * ||r_0|| / ||r_k||``, clipped to
       ``[inner_tol, inner_tol_max]``, goes to the inner solve as a 0-dim
       tensor (no host read). The outer beta is Polak-Ribière, which
       tolerates the resulting non-stationarity.

    Hooks: ``apply_bt_w(d)`` takes a pressure direction (n_p,) to B^T d in
    the reduced velocity layout; ``solve_a(rhs_red, x0_red, tol_k) -> (y,
    info)`` is the inner A-solve there; ``schur_out(y)`` the mean-projected
    B y (n_p,); ``precond_p(r)`` the lumped-pressure-mass preconditioner;
    ``dot_w(a, b)`` the dot in the reduced layout.

    Returns ``(p_flat, res_fin, k_out, atol, inner_iters, u_bt)``; the
    caller judges convergence as ``res_fin <= atol`` and runs its own
    velocity recovery. ``inner_iters`` (an int) counts the inner PCG
    iterations of the initial Schur apply and every outer step. ``u_bt =
    y_0 + sum_k alpha_k y_k`` approximates A^{-1} B^T p at no cost, so the
    caller's recovery ``A u = f - B^T p`` warm-starts from ``u_f - u_bt``.

    Guards for loose inner solves: the best iterate (smallest outer
    residual, with its ``u_bt``) is returned if the final one is worse; a
    non-positive curvature or a non-finite update stops the loop without
    applying the step; and the loop stops after ``stall_patience``
    iterations without a new best residual.
    """
    tiny = torch.finfo(rhs_p.dtype).tiny
    zero = rhs_p.new_zeros(())
    b_norm = torch.sqrt(torch.sum(rhs_p * rhs_p))
    atol = tol * torch.clamp(b_norm, min=tiny)

    def schur_apply(d_flat, y_prev, w_prev, tol_k):
        w = apply_bt_w(d_flat)
        gamma = dot_w(w, w_prev) / torch.clamp(dot_w(w_prev, w_prev), min=tiny)
        y, info = solve_a(w, gamma * y_prev, tol_k)
        return schur_out(y), y, w, info.iterations

    # the initial residual: one Schur apply against the caller's x0 (zero by
    # default, where the inner PCG exits after 0 iterations on ||b|| = 0)
    sx0, y0, w0, it0 = schur_apply(x0, zeros_red, zeros_red, inner_tol)
    r = rhs_p - sx0
    z = precond_p(r)
    r0_norm = torch.sqrt(torch.sum(r * r))
    xp, d, rz, y_prev, w_prev, k, it_tot, u_bt = x0, z, torch.sum(r * z), y0, w0, 0, it0, y0
    best_xp, best_ubt, best_norm = x0, y0, r0_norm
    r_norm = r0_norm
    since_best = torch.zeros((), dtype=torch.int64, device=rhs_p.device)
    stop = torch.zeros((), dtype=torch.bool, device=rhs_p.device)
    # the one host read of an outer iteration: the loop condition
    while k < outer_cap and bool(
        torch.stack([r_norm > atol, ~stop, since_best < stall_patience]).all()
    ):
        tol_k = torch.clamp(
            inner_eta * tol * r0_norm / torch.clamp(r_norm, min=tiny),
            min=inner_tol,
            max=inner_tol_max,
        )
        sd, y_new, w_new, it_k = schur_apply(d, y_prev, w_prev, tol_k)
        denom = torch.sum(d * sd)
        # inexact applies can present an indefinite operator; a
        # non-positive-curvature step would diverge: stop without it
        ok = denom > 0
        alpha = torch.where(ok, rz / torch.where(ok, denom, 1.0), zero)
        xp_new = xp + alpha * d
        u_bt_new = u_bt + alpha * y_new
        r_new = r - alpha * sd
        z_new = precond_p(r_new)
        # Polak-Ribière (flexible) beta
        beta = torch.sum((r_new - r) * z_new) / rz
        rz = torch.sum(r_new * z_new)
        d = z_new + beta * d
        new_norm = torch.sqrt(torch.sum(r_new * r_new))
        stop = ~ok | ~torch.isfinite(new_norm) | ~torch.isfinite(rz)
        improved = ~stop & (new_norm < best_norm)
        best_xp = torch.where(improved, xp_new, best_xp)
        best_ubt = torch.where(improved, u_bt_new, best_ubt)
        best_norm = torch.where(improved, new_norm, best_norm)
        since_best = torch.where(improved, 0, since_best + 1)
        # a stopped step keeps the previous iterate (the bad update is never
        # applied); the loop then exits on its condition
        keep = ~stop
        xp = torch.where(keep, xp_new, xp)
        r = torch.where(keep, r_new, r)
        r_norm = torch.where(keep, new_norm, r_norm)
        u_bt = torch.where(keep, u_bt_new, u_bt)
        y_prev, w_prev = y_new, w_new
        k += 1
        it_tot += it_k
    res_fin = r_norm
    # the best iterate seen (the final one whenever the loop converged
    # monotonically; it differs only on floor or stall exits)
    take_best = best_norm < res_fin
    p_flat = torch.where(take_best, best_xp, xp)
    u_bt = torch.where(take_best, best_ubt, u_bt)
    return p_flat, torch.minimum(res_fin, best_norm), k, atol, it_tot, u_bt


def lumped_mass(pressure_basis, mass_form: Optional[Callable] = None):
    """The lumped pressure mass (n_p, 1): the row sums of M_p, scattered
    from the local row sums; ``mass_form`` defaults to ``q.v @ q.v^T``."""
    if mass_form is None:
        mass_form = lambda b_: b_.v @ b_.v.mT  # noqa: E731
    Vp = pressure_basis
    return Vp._assemble_linear_from_local(
        Vp.integrate_bilinear_form_local(mass_form).sum(-1, keepdim=True)
    )


def stokes_solver(
    velocity_basis,
    pressure_basis,
    a_form: Callable,
    b_form: Callable,
    *,
    tol: float = 1e-8,
    maxiter: Optional[int] = None,
    inner_tol: float = 1e-11,
    inner_precondition: str = "two_level",
    mass_form: Optional[Callable] = None,
):
    """Build ``solve(f, g=None, x0=None) -> (u, p, StokesInfo)`` for a
    fixed pair of bases and forms: Schur-complement PCG whose every inner
    A-solve is :meth:`AbstractBasis.solve_iterative` (``symmetric_form``,
    ``precondition=inner_precondition``) to ``inner_tol``, each assembling
    A and setting its preconditioner up anew, as the JAX eager solver does.

    Args:
      velocity_basis: the A-block basis (typically a ``VectorBasis``); its
        Dirichlet velocity DOFs are homogeneous (lift non-homogeneous data
        into ``f``/``g`` first).
      pressure_basis: the constraint-space basis (no Dirichlet DOFs; the
        constant mode is projected out, not pinned).
      a_form: closure ``basis -> (T, q, n_u_loc, n_u_loc)`` for A (SPD).
      b_form: closure ``(test_p, trial_u) -> (T, q, n_p_loc, n_u_loc)`` for
        B (e.g. ``-q div u``), with matching integration orders.
      tol: relative Schur-CG tolerance.
      inner_tol: tolerance of the inner A-solves; keep it well below tol.
      mass_form: pressure mass integrand (defaults to ``q.v @ q.v^T``), for
        the lumped preconditioner and the mean projection.

    The returned pressure has zero lumped-mass mean.
    """
    Vu, Vp = velocity_basis, pressure_basis
    local_a = Vu.integrate_bilinear_form_local(a_form)
    local_b = Vp.integrate_mixed_bilinear_form_local(Vu, b_form)
    mp_lumped = lumped_mass(Vp, mass_form)
    mp_total = mp_lumped.sum()
    u_dofs = Vu._global_dofs4elements.long()
    p_dofs = Vp._global_dofs4elements.long()
    local_bt = local_b.mT

    def apply_b(u_vec):
        """B u: (n_u, 1) -> (n_p, 1)."""
        return Vp._assemble_linear_from_local(local_b @ u_vec[:, 0][u_dofs][..., None])

    def apply_bt(p_vec):
        """B^T p: (n_p, 1) -> (n_u, 1)."""
        return Vu._assemble_linear_from_local(local_bt @ p_vec[:, 0][p_dofs][..., None])

    def project_mean(p_vec):
        """Remove the constant mode in the lumped-M_p inner product."""
        return p_vec - (mp_lumped * p_vec).sum() / mp_total

    def solve_a(rhs):
        return Vu.solve_iterative(
            local_a,
            rhs,
            tol=inner_tol,
            precondition=inner_precondition,
            symmetric_form=True,
            return_info=True,
        )

    inv_lump = 1.0 / mp_lumped[:, 0]

    def schur(p_flat):
        y, _ = solve_a(apply_bt(p_flat[:, None]))
        return project_mean(apply_b(y))[:, 0]

    def solve(f, g=None, x0=None):
        u_f, _ = solve_a(f)
        rhs_p = apply_b(u_f)
        if g is not None:
            rhs_p = rhs_p - g
        rhs_p = project_mean(rhs_p)
        p_flat, schur_info = pcg(
            schur,
            rhs_p[:, 0],
            x0=None if x0 is None else x0[:, 0],
            precond=lambda r: project_mean((inv_lump * r)[:, None])[:, 0],
            tol=tol,
            maxiter=maxiter,
        )
        p = project_mean(p_flat[:, None])
        u, info_u = solve_a(f - apply_bt(p))
        info = StokesInfo(
            outer_iterations=schur_info.iterations,
            schur_residual=schur_info.residual_norm,
            converged=schur_info.converged,
            inner_info=info_u,
        )
        return u, p, info

    return solve
