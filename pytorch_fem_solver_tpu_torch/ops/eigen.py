"""Generalized symmetric eigensolvers: the smallest modes of A x = λ M x.

Counterpart of ``pytorch_fem_solver_tpu/ops/eigen.py``: shift-invert
subspace iteration (``subspace_eigsh``, and ``subspace_eigsh_while`` with the
stopping test of the JAX ``lax.while_loop``) and blocked LOBPCG
(``lobpcg_eigsh``). The JAX loops become host loops that read the stopping
test once per round. Operators act on single vectors ``(n,)``; a block
``(n, m)`` is applied one column at a time, on a contiguous copy of each
column (the SpMV kernel K2 takes a contiguous vector), where JAX ``vmap``s
the operator. Each column's inner PCG solve is its own loop with its own
stopping test, as the ``vmap`` of JAX's ``while_loop`` freezes each finished
column.

The small dense steps (Gram matrices of m or 3m columns) go through
``torch.linalg``: the Cholesky of the Rayleigh-Ritz step by
``cholesky_ex`` (a failed factor becomes NaN, as JAX's does, with no read of
its status), and every ``eigh``, which on the card reads its status back to
the host. Eigenvector signs and rotations inside a cluster of equal
eigenvalues may differ from the JAX package's LAPACK; the eigenvalues and
the spans do not.

Under a profiler session (``utils.profiling``) each loop records the host
span ``fem.eigsh``; inside it every A- or M-block product
``fem.eigsh.product`` (the column copies and the stack included) and, in
LOBPCG, the block application of the preconditioner ``fem.eigsh.precond``
and each dense Rayleigh-Ritz step ``fem.eigsh.rr`` (the seed step, each
``whiten`` and ``rr_ortho``: the Gram products, the whitening and the
``eigh`` calls), each with a CUDA event pair on the card; the counters
``eigsh_rounds``, ``eigsh_products`` and ``eigsh_product_columns``; and
each stop test through ``read``.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from .. import config
from ..utils.profiling import count, read, span
from .solvers import pcg

__all__ = [
    "EighInfo",
    "lobpcg_eigsh",
    "subspace_eigsh",
    "subspace_eigsh_while",
]


class EighInfo(NamedTuple):
    iterations: int
    eig_change: float
    converged: bool


def _block(matvec):
    """The action of ``matvec`` on an (n, m) block, column by column."""

    def apply(s):
        cols = s.T.contiguous()
        return torch.stack([matvec(c) for c in cols], dim=1)

    return apply


def _products(matvec, device):
    """``_block(matvec)`` recorded as one ``fem.eigsh.product`` and
    counted under ``eigsh_products`` and ``eigsh_product_columns``."""
    apply = _block(matvec)

    def product(s):
        count("eigsh_products")
        count("eigsh_product_columns", s.shape[1])
        with span("fem.eigsh.product", device):
            return apply(s)

    return product


def _sym(g):
    return 0.5 * (g + g.T)


def _relative_change(head, head_prev, floor):
    return torch.max(torch.abs(head - head_prev) / torch.clamp(torch.abs(head), min=floor))


def _rayleigh_ritz(y, a_mv, m_mv):
    """Project onto span(y): return (eigenvalues, coefficient matrix)."""
    g_a = _sym(y.T @ a_mv(y))
    g_m = _sym(y.T @ m_mv(y))
    chol, info = torch.linalg.cholesky_ex(g_m)
    chol = torch.where(info == 0, chol, torch.full_like(chol, math.nan))
    eye = torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device)
    li = torch.linalg.solve_triangular(chol, eye, upper=False)
    vals, w = torch.linalg.eigh(_sym(li @ g_a @ li.T))
    return vals, li.T @ w


def _inner_solver(a_matvec, precond, precond_diag, solve_tol, solve_maxiter):
    """y = A^{-1} b for each column of an (n, m) block, one PCG per column."""

    def solve_col(b):
        y, _ = pcg(
            a_matvec,
            b,
            precond=precond,
            precond_diag=precond_diag,
            tol=solve_tol,
            maxiter=solve_maxiter,
        )
        return y

    return _block(solve_col)


def subspace_eigsh(
    a_matvec: Callable[[torch.Tensor], torch.Tensor],
    m_matvec: Callable[[torch.Tensor], torch.Tensor],
    n: int,
    k: int = 6,
    *,
    n_extra: Optional[int] = None,
    tol: float = 1e-9,
    max_rounds: int = 60,
    solve_tol: float = 1e-10,
    solve_maxiter: Optional[int] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond_diag: Optional[torch.Tensor] = None,
    seed: int = 0,
    dtype: Optional[torch.dtype] = None,
    x0: Optional[torch.Tensor] = None,
    device=None,
):
    """Smallest ``k`` eigenpairs of the pencil (A, M), both SPD.

    Args:
      a_matvec / m_matvec: operator actions on single vectors (n,).
      n: reduced system size.
      k: number of eigenpairs to return.
      n_extra: guard vectors beyond ``k`` (default ``max(2, k // 2)``): the
        trailing subspace vectors converge slowest, so the guard keeps the
        returned pairs accurate.
      tol: relative eigenvalue-change stopping threshold between rounds.
      solve_tol / solve_maxiter / precond / precond_diag: inner PCG knobs
        for the A-solves.
      seed / dtype / device: the starting block, NumPy's
        ``default_rng(seed).standard_normal((n, m))`` in ``dtype`` (default
        ``config.default_dtype()``) on ``config.resolve_device(device)``.
      x0: explicit starting block (n, >=m), required when the operators act
        on a padded layout (the BSR-reduced system, whose padding rows must
        start and stay exactly zero); the random default fills every row.

    Returns ``(eigenvalues (k,), eigenvectors (n, k), EighInfo)`` with
    M-orthonormal eigenvectors, eigenvalues ascending. The host reads the
    leading eigenvalues once per round.
    """
    if dtype is None:
        dtype = config.default_dtype()
    m = min(n, k + (n_extra if n_extra is not None else max(2, k // 2)))
    if k > n:
        raise ValueError(f"requested k={k} eigenpairs from an n={n} system")

    if x0 is not None:
        if x0.shape[0] != n or x0.shape[1] < m:
            raise ValueError(f"x0 must be ({n}, >={m}); got {tuple(x0.shape)}")
        x = x0[:, :m].to(dtype)
    else:
        rng = np.random.default_rng(seed)
        x = torch.as_tensor(
            rng.standard_normal((n, m)), dtype=dtype, device=config.resolve_device(device)
        )

    a_blk, m_blk = _products(a_matvec, x.device), _products(m_matvec, x.device)
    solve_block = _inner_solver(a_matvec, precond, precond_diag, solve_tol, solve_maxiter)

    last = None
    info = EighInfo(iterations=0, eig_change=np.inf, converged=False)
    with span("fem.eigsh"):
        for rounds in range(1, max_rounds + 1):
            count("eigsh_rounds")
            # y = A^{-1} (M x), then Rayleigh-Ritz on span(y)
            y = solve_block(m_blk(x))
            vals, coeffs = _rayleigh_ritz(y, a_blk, m_blk)
            x = y @ coeffs
            head = vals[:k]
            if last is not None:
                change = read(_relative_change(head, last, 1e-300))
                info = EighInfo(iterations=rounds, eig_change=change, converged=change <= tol)
                if info.converged:
                    break
            last = head
    return vals[:k], x[:, :k], info


def subspace_eigsh_while(
    a_matvec,
    m_matvec,
    x0: torch.Tensor,
    k: int,
    *,
    tol: float = 1e-9,
    max_rounds: int = 60,
    solve_tol: float = 1e-10,
    solve_maxiter: Optional[int] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond_diag: Optional[torch.Tensor] = None,
):
    """:func:`subspace_eigsh` with the JAX ``lax.while_loop`` core's
    stopping test (the relative change of the leading ``k`` values against
    the previous round's, starting from infinity) and no host copy of the
    values: the host reads ``change > tol`` once per round. ``x0`` (n, m >=
    k) is the starting block (zero on any padding rows). Returns ``(vals
    (k,), vecs (n, k), (rounds, eig_change, converged))``: ``rounds`` a
    Python int, the other two 0-dim tensors."""
    a_blk, m_blk = _products(a_matvec, x0.device), _products(m_matvec, x0.device)
    solve_block = _inner_solver(a_matvec, precond, precond_diag, solve_tol, solve_maxiter)

    x = x0
    head = torch.full((k,), math.inf, dtype=x0.dtype, device=x0.device)
    change = torch.tensor(math.inf, dtype=x0.dtype, device=x0.device)
    rounds = 0
    with span("fem.eigsh"):
        while rounds < max_rounds and read(change > tol):
            count("eigsh_rounds")
            y = solve_block(m_blk(x))
            vals, coeffs = _rayleigh_ritz(y, a_blk, m_blk)
            x = y @ coeffs
            head_prev, head = head, vals[:k]
            change = _relative_change(head, head_prev, 1e-300)
            rounds += 1
    # one more Rayleigh-Ritz would be redundant: head and x are consistent
    return head, x[:, :k], (rounds, change, change <= tol)


def lobpcg_eigsh(
    a_matvec,
    m_matvec,
    x0: torch.Tensor,
    k: int,
    *,
    tol: float = 1e-9,
    max_rounds: int = 500,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    precond_diag: Optional[torch.Tensor] = None,
    lock_tol: Optional[float] = None,
    psum: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Blocked LOBPCG (Knyazev) for the smallest ``k`` pairs of (A, M).

    The stopping rule of :func:`subspace_eigsh_while` (relative change of
    the leading ``k`` values between rounds <= ``tol``), with a cheaper
    round: one A- and one M-block product and one preconditioner
    application per column, where subspace iteration runs a full inner PCG
    per column. The trial space is [X, T(A X - M X Λ), P].

    Written out as the JAX package has it: the seed step on the
    column-normalised start block (``rr_seed``); W and P M-projected off
    the earlier blocks and whitened blockwise by a rank-revealing ``eigh``
    of their own Gram (``whiten``; directions below ``10 width eps dmax``
    become zero columns); soft locking (a column whose relative residual
    ``||A x - λ M x|| / (||A x|| + |λ| ||M x||)`` is at most ``lock_tol``,
    default ``sqrt(tol)``, contributes no W direction); and ``rr_ortho``,
    the standard ``eigh`` of the projected A with rank-dropped columns
    pushed to ``2 max|ga| + 1``.

    ``psum`` sums the Gram matrices and column norms across row shards of
    a distributed block (identity by default).

    A round makes 6 m operator products (m the block width) in 5 block
    products (A X, M X, M W, M P, A [W, P]), one preconditioner
    application and 3 ``eigh`` calls, and the host reads the stopping test
    once; the seed step adds 2 block products (2 m columns). The spans and
    counters are the module's. Returns
    ``(vals (k,), vecs (n, k), (rounds, eig_change, converged))``:
    ``rounds`` a Python int, the other two 0-dim tensors.
    """
    n, m = x0.shape
    dtype, device = x0.dtype, x0.device
    if lock_tol is None:
        lock_tol = float(np.sqrt(tol))
    if psum is None:
        psum = lambda x: x  # noqa: E731
    a_blk, m_blk = _products(a_matvec, device), _products(m_matvec, device)
    if precond is not None:
        t_blk = _block(precond)
    elif precond_diag is not None:
        safe = torch.where(precond_diag != 0, precond_diag, torch.ones_like(precond_diag))
        t_blk = lambda r: r / safe[:, None]  # noqa: E731
    else:
        t_blk = lambda r: r  # noqa: E731
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny

    def colnorm(s):
        return torch.sqrt(psum(torch.sum(s * s, dim=0)))

    def normalized(s):
        return s / torch.clamp(colnorm(s), min=tiny)[None, :]

    def masked_inv_sqrt(d, width):
        dmax = torch.clamp(torch.max(torch.abs(d)), min=tiny)
        keep = d > (10.0 * width * eps) * dmax
        safe_d = torch.where(keep, d, torch.ones_like(d))
        return torch.where(keep, 1.0 / torch.sqrt(safe_d), torch.zeros_like(d)), keep

    def push_dropped(g, valid):
        big = 2.0 * torch.max(torch.abs(g)) + 1.0
        return g + torch.diag(torch.where(valid, torch.zeros_like(big), big))

    def whiten(s, ms, width):
        """M-orthonormalise block ``s`` (its M-image ``ms`` given) by a
        rank-revealing eigendecomposition of the small Gram s^T M s.
        Rank-dropped directions become zero columns; returns the
        transformed (s, ms, valid-column mask)."""
        with span("fem.eigsh.rr", device):
            d, q = torch.linalg.eigh(_sym(psum(s.T @ ms)))
            inv_sqrt, keep = masked_inv_sqrt(d, width)
            t = q * inv_sqrt[None, :]
            return s @ t, ms @ t, keep

    def rr_ortho(s, as_, valid):
        """Rayleigh-Ritz on an (approximately) M-orthonormal basis."""
        with span("fem.eigsh.rr", device):
            return torch.linalg.eigh(push_dropped(_sym(psum(s.T @ as_)), valid))

    def rr_seed(s, width):
        """Rank-tolerant generalised Rayleigh-Ritz, once, on the raw start
        block (not yet M-orthonormal)."""
        as_, ms = a_blk(s), m_blk(s)
        with span("fem.eigsh.rr", device):
            ga = _sym(psum(s.T @ as_))
            gm = _sym(psum(s.T @ ms))
            d, q = torch.linalg.eigh(gm)
            inv_sqrt, mask = masked_inv_sqrt(d, width)
            w = q * inv_sqrt[None, :]
            evals, evecs = torch.linalg.eigh(push_dropped(_sym(w.T @ ga @ w), mask))
            return evals, w @ evecs

    with span("fem.eigsh"):
        # seed Ritz step on X alone: M-orthonormal X and the initial Λ; the
        # coefficients belong to the column-normalised basis they came from
        x0n = normalized(x0)
        evals0, c0 = rr_seed(x0n, m)
        x = x0n @ c0[:, :m]
        lam = evals0[:m]
        p = torch.zeros_like(x)
        head = torch.full((k,), math.inf, dtype=dtype, device=device)
        change = torch.tensor(math.inf, dtype=dtype, device=device)
        valid_x = torch.ones((m,), dtype=torch.bool, device=device)

        rounds = 0
        while rounds < max_rounds and read(change > tol):
            count("eigsh_rounds")
            ax = a_blk(x)
            mx = m_blk(x)
            r = ax - mx * lam[None, :]
            # soft locking: converged columns contribute no residual direction
            locked = colnorm(r) <= lock_tol * torch.clamp(
                colnorm(ax) + torch.abs(lam) * colnorm(mx), min=tiny
            )
            with span("fem.eigsh.precond", device):
                tr = t_blk(r)
            w = torch.where(locked[None, :], torch.zeros_like(r), tr)
            # M-project W off X (M-orthonormal, so the coefficients are
            # (M X)^T W), pre-scale its columns to unit 2-norm (the same scale
            # on its M-image, so the Gram stays exact) and whiten it
            w = w - x @ psum(mx.T @ w)
            mw = m_blk(w)
            wscale = 1.0 / torch.clamp(colnorm(w), min=tiny)
            w, mw, w_keep = whiten(w * wscale[None, :], mw * wscale[None, :], m)
            # P: M-project off X and W, then whiten
            p = p - x @ psum(mx.T @ p)
            p = p - w @ psum(mw.T @ p)
            mp = m_blk(p)
            pscale = 1.0 / torch.clamp(colnorm(p), min=tiny)
            p, mp, p_keep = whiten(p * pscale[None, :], mp * pscale[None, :], m)
            s = torch.cat([x, w, p], dim=1)
            as_ = torch.cat([ax, a_blk(torch.cat([w, p], dim=1))], dim=1)
            evals, c = rr_ortho(s, as_, torch.cat([valid_x, w_keep, p_keep]))
            x = s @ c[:, :m]
            # next conjugate directions: the W/P part of the update only
            p = s[:, m:] @ c[m:, :m]
            lam = evals[:m]
            head_prev, head = head, evals[:k]
            change = _relative_change(head, head_prev, tiny)
            rounds += 1
    return head, x[:, :k], (rounds, change, change <= tol)
