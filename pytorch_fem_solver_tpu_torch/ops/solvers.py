"""Linear solvers: dense direct, preconditioned CG, MINRES and BiCGStab.

Counterpart of ``dense_solve``, ``pcg``, ``cg``, ``pcg_cols``, ``minres``,
``bicgstab`` and ``PCGInfo`` in ``pytorch_fem_solver_tpu/ops/solvers.py``
(the multi-column PCG and MINRES serve the Stokes solvers). The JAX loops are
``lax.while_loop``s on the device; here the loops run on the host with one
device-to-host read of the stopping test per iteration. ``pcg_steps`` is
the fixed-length loop with no host read, which ``bench.make_fused_pcg``
captures as a CUDA graph; routing ``pcg`` itself onto the device is queued
in ROADMAP.md (B2). The stopping rules, the default ``maxiter``, the
``converged`` tests and BiCGStab's breakdown guards are the JAX package's,
so iteration counts match. ``PCGInfo.iterations`` is a Python int.
``pcg``, ``minres`` and ``bicgstab`` take the JAX package's ``dot``
argument: the row-sharded solves of ``parallel`` pass a dot that sums the
rank-local products over the process group (``torch.dot`` when omitted).
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


def _squared_tolerance(b, tol, dot=torch.dot):
    """(tol * ||b||)^2, ``||b||`` through ``dot``; in float32 the 1e-300
    floor rounds to 0, exactly as in the JAX package."""
    b_norm = torch.sqrt(dot(b, b))
    return (tol * torch.clamp(b_norm, min=1e-300)) ** 2


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    dot: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
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
      dot: inner product (``torch.dot`` when None); a sharded solve passes
        one that sums the local products over its process group.

    Returns ``(x, PCGInfo)``.
    """
    n = b.shape[-1]
    if maxiter is None:
        maxiter = max(10 * n, 100)
    if dot is None:
        dot = torch.dot
    precond = _jacobi_or_identity(precond, precond_diag)
    atol2 = _squared_tolerance(b, tol, dot)

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


def pcg_cols(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    B: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol=1e-10,
    maxiter: Optional[int] = None,
):
    """Block-diagonal multi-rhs PCG: m independent CG recurrences on the
    same operator, advanced in lockstep on (n, m) column stacks (not
    block-CG: each column keeps its own alpha and beta).

    Converged columns are frozen (their alpha, beta and p masked), so the
    loop runs to the last column's convergence without perturbing finished
    ones; one host read per iteration, of ``any(active)``. ``tol`` is the
    per-column relative tolerance (a float, a 0-dim or an (m,) tensor).
    Returns ``(X, PCGInfo)`` with ``iterations`` the shared loop count
    (an int) and ``residual_norm`` per column; ``converged`` is the 0-dim
    test that every column met its tolerance.
    """
    n, m = B.shape
    if maxiter is None:
        maxiter = max(10 * n, 100)
    if precond is None:
        precond = lambda r: r  # noqa: E731
    zero, one = B.new_zeros(()), B.new_ones(())
    tol = tol.to(B.dtype) if isinstance(tol, torch.Tensor) else B.new_full((), tol)

    def dot(u, v):
        return torch.sum(u * v, dim=0)  # (m,)

    atol2 = tol**2 * torch.clamp(dot(B, B), min=torch.finfo(B.dtype).tiny)
    x = torch.zeros_like(B) if x0 is None else x0
    r = B - matvec(x)
    p = precond(r)
    rz = dot(r, p)
    active = dot(r, r) > atol2
    k = 0
    while k < maxiter and bool(active.any()):
        ap = matvec(p)
        denom = dot(p, ap)
        alpha = torch.where(active, rz / torch.where(denom == 0, one, denom), zero)
        x = x + alpha[None, :] * p
        r = r - alpha[None, :] * ap
        z = precond(r)
        rz_new = dot(r, z)
        beta = torch.where(active, rz_new / torch.where(rz == 0, one, rz), zero)
        p = torch.where(active[None, :], z + beta[None, :] * p, p)
        rz = torch.where(active, rz_new, rz)
        k += 1
        active = dot(r, r) > atol2
    res = torch.sqrt(dot(r, r))
    return x, PCGInfo(iterations=k, residual_norm=res, converged=torch.all(res * res <= atol2))


def minres(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    restart: Optional[int] = None,
    dot: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """Preconditioned MINRES (Paige & Saunders) for symmetric, possibly
    indefinite operators, such as the Stokes saddle-point system.

    Args:
      precond: an SPD preconditioner M^{-1} (or a PSD one whose nullspace
        is orthogonal to the residuals, e.g. the mean-projected pressure
        mass inverse); the identity when omitted.
      tol: relative tolerance on the M^{-1}-norm residual, the norm the
        Lanczos recurrence tracks.
      restart: when set, every ``restart`` iterations the true residual
        ``b - K x`` is recomputed and the recurrence re-seeded from it
        (the float32 cure for a tracked residual that drifts from the true
        one); the final ``residual_norm`` and ``converged`` then come from
        the true residual too. ``restart=None`` means no restarts; a value
        below 1 raises ``ValueError`` before any work.
      dot: inner product, as in :func:`pcg`.

    One host read per iteration, of the two-part stopping test (the
    tracked residual above ``tol`` and no Lanczos breakdown). The JAX
    ``lax.cond`` of the refresh is a Python ``if`` on the iteration count.
    Returns ``(x, PCGInfo)``; ``residual_norm`` is the preconditioned norm.
    """
    n = b.shape[-1]
    if restart is not None and int(restart) < 1:
        raise ValueError(f"restart must be >= 1 (or None), got {restart}")
    if maxiter is None:
        maxiter = max(10 * n, 100)
    if dot is None:
        dot = torch.dot
    if precond is None:
        precond = lambda r: r  # noqa: E731
    eps = torch.finfo(b.dtype).eps
    tiny = torch.finfo(b.dtype).tiny
    zero, one = b.new_zeros(()), b.new_ones(())

    def seed(x):
        """A fresh recurrence from the residual at ``x``: (r1, r2, y, oldb,
        beta, dbar, epsln, phibar, cs, sn, w, w2)."""
        r = b - matvec(x)
        y = precond(r)
        # the PSD contract keeps <r, y> >= 0; clamp its float32 rounding
        beta = torch.sqrt(torch.clamp(dot(r, y), min=0.0))
        return (r, r, y, zero, beta, zero, zero, beta, -one, zero,
                torch.zeros_like(b), torch.zeros_like(b))

    x = torch.zeros_like(b) if x0 is None else x0
    r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn, w, w2 = seed(x)
    beta1 = beta
    rtol = tol * torch.clamp(beta1, min=tiny)
    breakdown = eps * torch.clamp(beta1, min=tiny)
    k = 0
    while k < maxiter and bool((phibar > rtol) & (beta > breakdown)):
        v = y / beta
        av = matvec(v)
        # three-term Lanczos: subtract the previous direction (none at k=0
        # and right after a true-residual refresh, both oldb == 0)
        has_prev = oldb > 0
        av = av - torch.where(has_prev, beta / torch.where(has_prev, oldb, one), zero) * r1
        alfa = dot(v, av)
        av = av - (alfa / beta) * r2
        r1, r2 = r2, av
        y = precond(r2)
        oldb = beta
        beta = torch.sqrt(torch.clamp(dot(r2, y), min=0.0))
        # the previous rotation applied to the new tridiagonal column
        oldeps = epsln
        delta = cs * dbar + sn * alfa
        gbar = sn * dbar - cs * alfa
        epsln = sn * beta
        dbar = -cs * beta
        gamma = torch.clamp(torch.sqrt(gbar**2 + beta**2), min=eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * phibar
        phibar = sn * phibar
        w1, w2 = w2, w
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = x + phi * w
        k += 1
        if restart is not None and k % restart == 0:
            r1, r2, y, oldb, beta, dbar, epsln, phibar, cs, sn, w, w2 = seed(x)
    if restart is not None:
        # the reported result is the true residual's, not the recurrence's
        r_true = b - matvec(x)
        phibar = torch.sqrt(torch.clamp(dot(r_true, precond(r_true)), min=0.0))
    return x, PCGInfo(iterations=k, residual_norm=phibar, converged=phibar <= rtol)


def bicgstab(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    dot: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
):
    """Preconditioned BiCGStab for non-symmetric operators (van der Vorst).

    Same interface as :func:`pcg` (``dot`` included); two matvecs and two
    preconditioner applications per iteration. Breakdown (rho or omega ~
    0) freezes the state and reports non-convergence rather than emitting
    NaNs, with the JAX package's guards, evaluated on the device with
    ``torch.where``.
    """
    n = b.shape[-1]
    if maxiter is None:
        maxiter = max(10 * n, 100)
    if dot is None:
        dot = torch.dot
    precond = _jacobi_or_identity(precond, precond_diag)
    atol2 = _squared_tolerance(b, tol, dot)
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
