"""Preconditioned conjugate gradients.

Counterpart of ``pcg`` and ``PCGInfo`` in
``pytorch_fem_solver_tpu/ops/solvers.py``. The JAX loop is one
``lax.while_loop`` on the device; here the loop runs on the host with one
device-to-host read of the stopping test per iteration. Keeping the loop on
the device (CUDA graphs over iteration chunks) is queued in ROADMAP.md (B).
The stopping rule, the default ``maxiter`` and the ``converged`` test are the
JAX package's, so iteration counts match. The JAX ``x0`` and ``dot``
arguments (the latter for sharded inner products) wait for the slices that
use them.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class PCGInfo(NamedTuple):
    iterations: int
    residual_norm: torch.Tensor
    converged: torch.Tensor


def pcg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    precond_diag: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
):
    """Preconditioned conjugate gradients from a zero initial guess.

    Args:
      matvec: SPD operator action on a vector shaped like ``b``.
      b: right-hand side (n,).
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
    if precond is None:
        if precond_diag is None:
            precond = lambda r: r  # noqa: E731
        else:
            safe = torch.where(
                precond_diag != 0, precond_diag, torch.ones_like(precond_diag)
            )
            inv_diag_arr = 1.0 / safe
            precond = lambda r: inv_diag_arr * r  # noqa: E731

    b_norm = torch.sqrt(dot(b, b))
    # in float32 the 1e-300 floor rounds to 0, exactly as in the JAX package
    atol2 = (tol * torch.clamp(b_norm, min=1e-300)) ** 2

    x = torch.zeros_like(b)
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
