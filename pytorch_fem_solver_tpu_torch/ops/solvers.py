"""Linear solvers: dense direct, preconditioned CG and BiCGStab.

Counterpart of ``dense_solve``, ``pcg``, ``cg``, ``bicgstab`` and
``PCGInfo`` in ``pytorch_fem_solver_tpu/ops/solvers.py``. The JAX loops are
``lax.while_loop``s on the device; here the loops run on the host with one
device-to-host read of the stopping test per iteration. ``pcg_steps`` is
the fixed-length loop with no host read, which ``bench.make_fused_pcg``
captures as a CUDA graph; routing ``pcg`` itself onto the device is queued
in ROADMAP.md (B2). The stopping rules, the default ``maxiter``, the
``converged`` tests and BiCGStab's breakdown guards are the JAX package's,
so iteration counts match. ``PCGInfo.iterations`` is a Python int. The JAX
``dot`` argument (for sharded inner products) waits for the slice that uses
it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class PCGInfo(NamedTuple):
    iterations: int
    residual_norm: torch.Tensor
    converged: torch.Tensor


def dense_solve(matrix, vector):
    """Dense LU solve."""
    return torch.linalg.solve(matrix, vector)


def _jacobi_or_identity(precond, precond_diag):
    """``precond`` if given, else point Jacobi on ``precond_diag`` (zeros
    treated as ones), else the identity."""
    if precond is not None:
        return precond
    if precond_diag is None:
        return lambda r: r  # noqa: E731
    safe = torch.where(precond_diag != 0, precond_diag, torch.ones_like(precond_diag))
    inv_diag_arr = 1.0 / safe
    return lambda r: inv_diag_arr * r  # noqa: E731


def _squared_tolerance(b, tol):
    """(tol * ||b||)^2; in float32 the 1e-300 floor rounds to 0, exactly as
    in the JAX package."""
    b_norm = torch.sqrt(torch.dot(b, b))
    return (tol * torch.clamp(b_norm, min=1e-300)) ** 2


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
):
    """Preconditioned conjugate gradients.

    Args:
      matvec: SPD operator action on a vector shaped like ``b``.
      b: right-hand side (n,).
      x0: initial guess (defaults to zeros): r0 = b - A x0, z0 = M r0.
      precond_diag: operator diagonal; Jacobi preconditioner M = diag(A).
      precond: general SPD preconditioner application z = M^{-1} r
        (overrides ``precond_diag``).
      tol: relative residual tolerance ||r|| <= tol * ||b||.
      maxiter: iteration cap (defaults to max(10 * n, 100)).

    Returns ``(x, PCGInfo)``.
    """
    n = b.shape[-1]
    if maxiter is None:
        maxiter = max(10 * n, 100)
    dot = torch.dot
    precond = _jacobi_or_identity(precond, precond_diag)
    atol2 = _squared_tolerance(b, tol)

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    p = precond(r)
    rz = dot(r, p)
    k = 0
    while k < maxiter and bool(dot(r, r) > atol2):
        ap = matvec(p)
        alpha = rz / dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        k += 1
    res = torch.sqrt(dot(r, r))
    info = PCGInfo(iterations=k, residual_norm=res, converged=res <= torch.sqrt(atol2))
    return x, info


def cg(matvec, b, **kwargs):
    """Unpreconditioned CG (Jacobi disabled)."""
    kwargs.setdefault("precond_diag", None)
    return pcg(matvec, b, **kwargs)


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
):
    """Preconditioned BiCGStab for non-symmetric operators (van der Vorst).

    Same interface as :func:`pcg`; two matvecs and two preconditioner
    applications per iteration. Breakdown (rho or omega ~ 0) freezes the
    state and reports non-convergence rather than emitting NaNs, with the
    JAX package's guards, evaluated on the device with ``torch.where``.
    """
    n = b.shape[-1]
    if maxiter is None:
        maxiter = max(10 * n, 100)
    dot = torch.dot
    precond = _jacobi_or_identity(precond, precond_diag)
    atol2 = _squared_tolerance(b, tol)
    eps = torch.finfo(b.dtype).tiny
    zero, one = b.new_zeros(()), b.new_ones(())

    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r  # shadow residual, fixed
    p, v = torch.zeros_like(b), torch.zeros_like(b)
    rho, alpha, omega = one, one, one
    ok = torch.ones((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and bool((dot(r, r) > atol2) & ok):
        rho_new = dot(rhat, r)
        ok = rho_new.abs() > eps
        beta = torch.where(ok, (rho_new / rho) * (alpha / omega), zero)
        p = r + beta * (p - omega * v)
        p_hat = precond(p)
        v = matvec(p_hat)
        rhat_v = dot(rhat, v)
        ok = ok & (rhat_v.abs() > eps)
        alpha = torch.where(ok, rho_new / torch.where(ok, rhat_v, one), zero)
        s = r - alpha * v
        s_hat = precond(s)
        t = matvec(s_hat)
        tt = dot(t, t)
        omega_ok = tt > eps
        omega = torch.where(omega_ok, dot(t, s) / torch.where(omega_ok, tt, one), zero)
        omega_ok = omega_ok & (omega.abs() > eps)
        # omega breakdown (t ~ 0): keep the alpha half step x + alpha p_hat
        # with residual s, then stop; rho/rhat_v breakdown: freeze entirely
        x_half = x + alpha * p_hat
        x = torch.where(ok, torch.where(omega_ok, x_half + omega * s_hat, x_half), x)
        r = torch.where(ok, torch.where(omega_ok, s - omega * t, s), r)
        ok = ok & omega_ok
        omega = torch.where(omega_ok, omega, one)
        rho = rho_new
        k += 1
    res = torch.sqrt(dot(r, r))
    info = PCGInfo(iterations=k, residual_norm=res, converged=res <= torch.sqrt(atol2))
    return x, info


def pcg_steps(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    precond: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    iters: int,
):
    """``iters`` PCG iterations from x0 = 0 and r0 = b, with no host read of
    the device; returns ``(x, r)``.

    The stock loop of ``tools/exp_pallas_fused_pcg.py`` (``run_stock``): a
    fixed trip count in place of the stopping test, so the loop can be
    captured as a CUDA graph.
    """
    x = torch.zeros_like(b)
    r = b
    p = precond(r)
    rz = torch.dot(r, p)
    for _ in range(iters):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, r
