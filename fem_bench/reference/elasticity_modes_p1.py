"""Plain P1 elastic modes: the reference of ``problems/elasticity_modes_p1.py``.

    K u = lambda M u,  the 6 (k) smallest pairs,

with K the stiffness of ``elasticity_p1.py`` (its own float64 assembly of
the Lame form scaled by E(x), u = 0 on the Dirichlet nodes) and M the
consistent P1 vector mass, assembled here from scratch on the same CSR
pattern: on a cell of volume |T|,

    M[(a, i), (b, j)] = rho |T| (1 + delta_ab) / 20 delta_ij,

which the degree-2 rule integrates exactly. Both in float64, plain PyTorch;
it imports nothing of the program under test and shares no code with its
eigensolver.

The eigensolver is its own: Rayleigh-Ritz for (K, M) on a block Krylov
space of the shift-invert operator K^-1 M, started from a block of k + 2
columns of NumPy's ``default_rng(seed)`` normals. Each step solves K Y =
M Q for the newest block by conjugate gradients on all its columns at once
(preconditioned by the inverses of K's nodal 3 x 3 diagonal blocks, to a
relative residual of 1e-10 each), M-orthonormalises Y against the space
(block Gram-Schmidt twice, then a Cholesky QR twice) and takes the Ritz
pairs of the whole space from K's and M's products with it, so that an
inexact solve can slow the space's growth but never bias a pair. After
``MAX_BLOCKS`` blocks the space restarts from its k + 2 lowest Ritz
vectors. It stops when every one of the k pairs has the relative residual

    ||K x - lambda M x|| / (||K x|| + lambda ||M x||) <= RES_TOL,

and reports a pencil that does not get there within ``MAX_STEPS`` steps
as not converged: such a reference judges nothing.

``modes(..., control="tf32")`` is the control: K and M rounded to TF32's
10-bit significand, then solved in float64 as above.
"""

from __future__ import annotations

import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from .elasticity_p1 import C
from .elasticity_p1 import Reference as Stiffness
from .p1 import MAXITER, round_tf32

#: the relative residual every returned pair meets
RES_TOL = 1e-8
#: columns of the block beyond the k wanted
GUARD = 2
#: blocks the space holds before it restarts
MAX_BLOCKS = 12
#: block steps before the pencil counts as not converged
MAX_STEPS = 200
#: relative residual of every column of the inner solves
CG_TOL = 1e-10


class Modes(NamedTuple):
    values: torch.Tensor  # (k,) ascending
    vectors: torch.Tensor  # (3 n, k) on the interior DOFs, M-orthonormal
    steps: int
    converged: bool


class Reference:
    """The stiffness of ``elasticity_p1.Reference`` and the consistent mass
    on its CSR pattern, built once on ``device``; ``modes`` per field."""

    def __init__(self, glued, device, degree: int = 2, nu: float = 0.3, rho: float = 1.0):
        self.stiffness = Stiffness(glued, device, degree, nu)
        s = self.stiffness
        self.device = s.device
        self.rows = C * s.n_nodes
        p = s.coords
        edges = p[:, 1:] - p[:, :1]
        volume = torch.sqrt(torch.linalg.det(edges @ edges.mT)) / 6.0
        eye4 = torch.eye(4, dtype=torch.float64, device=self.device)
        local = torch.einsum("ab,ij->aibj", (1.0 + eye4) / 20.0,
                             torch.eye(C, dtype=torch.float64, device=self.device))
        keep = s.pair >= 0
        self.mass = torch.zeros(s.nnz, dtype=torch.float64, device=self.device)
        for b0 in range(0, s.cells.shape[0], 1 << 18):
            b1 = min(b0 + (1 << 18), s.cells.shape[0])
            mats = (rho * volume[b0:b1])[:, None, None, None, None] * local
            k = keep[b0:b1]
            self.mass.index_add_(0, s.pos[s.pair[b0:b1][k]].reshape(-1),
                                 mats.permute(0, 1, 3, 2, 4)[k].reshape(-1))

    def stiffness_values(self, E: Callable) -> torch.Tensor:
        """K's CSR values (nnz,) for the Young's modulus ``E`` (points (...,
        3) -> (...))."""
        return self.stiffness.assemble(E, lambda x: torch.zeros_like(x))[0]

    def matrix(self, values: torch.Tensor) -> torch.Tensor:
        return self.stiffness.matrix(values)

    def interior(self, modes: np.ndarray, vertex_node: np.ndarray) -> torch.Tensor:
        """Modes given at the input vertices, (vertices, 3, k), as columns
        on this reference's interior DOFs (3 n, k), float64."""
        number = self.stiffness.number[vertex_node]
        inside = number >= 0
        out = np.zeros((self.rows, modes.shape[-1]))
        out.reshape(-1, C, modes.shape[-1])[number[inside]] = modes[inside]
        return torch.as_tensor(out, device=self.device)

    def residuals(self, k_values, m_values, lam, x) -> torch.Tensor:
        """||K x_i - lam_i M x_i|| / (||K x_i|| + lam_i ||M x_i||) of each
        column, float64."""
        kx, mx = self.matrix(k_values) @ x, self.matrix(m_values) @ x
        return ((kx - mx * lam).norm(dim=0)
                / (kx.norm(dim=0) + lam.abs() * mx.norm(dim=0)).clamp(min=1e-300))

    def modes(self, k_values: torch.Tensor, k: int, control: str | None = None,
              seed: int = 0) -> Modes:
        """The ``k`` smallest pairs of (K, M), K from ``k_values``."""
        torch.backends.cuda.matmul.allow_tf32 = False
        m_values = self.mass
        if control == "tf32":
            k_values, m_values = round_tf32(k_values).double(), round_tf32(m_values).double()
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        return block_krylov(self.matrix(k_values), self.matrix(m_values),
                            torch.linalg.inv(k_values[self.stiffness.diagonal]), k, seed)


def _orthonormalize(y, basis, m_op):
    """``y`` M-orthonormal and M-orthogonal to the blocks of ``basis``
    (pairs (Q, M Q)); returns (Y, M Y)."""
    for _ in range(2):
        for q, mq in basis:
            y = y - q @ (mq.T @ y)
    my = m_op @ y
    for _ in range(2):
        gram = y.T @ my
        chol = torch.linalg.cholesky(0.5 * (gram + gram.T))
        y = torch.linalg.solve_triangular(chol, y.T, upper=False).T
        my = torch.linalg.solve_triangular(chol, my.T, upper=False).T
    return y, my


def block_cg(A, B, inv_blocks, tol: float = CG_TOL, maxiter: int = MAXITER, every: int = 25):
    """CG on every column of ``B`` (n, b) at once, preconditioned by the
    nodal block inverses ``inv_blocks`` (n / 3, 3, 3), to ||r_j|| <= tol
    ||b_j|| for each column j, reading the residuals every ``every``
    iterations."""

    def precondition(r):
        return (inv_blocks @ r.reshape(-1, C, r.shape[1])).reshape(r.shape)

    x = torch.zeros_like(B)
    r = B.clone()
    z = precondition(r)
    p = z.clone()
    rz = (r * z).sum(0)
    stop = tol * B.norm(dim=0)
    for it in range(1, maxiter + 1):
        ap = A @ p
        alpha = rz / (p * ap).sum(0)
        x += alpha * p
        r -= alpha * ap
        if it % every == 0 and bool((r.norm(dim=0) <= stop).all()):
            break
        z = precondition(r)
        rz_new = (r * z).sum(0)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x


def block_krylov(K, M, inv_blocks, k: int, seed: int = 0) -> Modes:
    """The ``k`` smallest pairs of the SPD pencil (K, M) (sparse CSR,
    float64) by Rayleigh-Ritz on block Krylov spaces of K^-1 M (see the
    module's text)."""
    n = K.shape[0]
    b = min(k + GUARD, n)
    blocks = max(2, min(MAX_BLOCKS, n // b))
    start = np.random.default_rng(seed).standard_normal((n, b))
    q, mq = _orthonormalize(torch.as_tensor(start, device=inv_blocks.device), [], M)
    space = [(q, mq, K @ q)]
    with warnings.catch_warnings():  # PyTorch's notice that sparse CSR is in beta
        warnings.simplefilter("ignore", UserWarning)
        for step in range(1, MAX_STEPS + 1):
            y = block_cg(K, space[-1][1][:, :b], inv_blocks)
            y, my = _orthonormalize(y, [(q, mq) for q, mq, _ in space], M)
            space.append((y, my, K @ y))
            q, mq, kq = (torch.cat(z, dim=1) for z in zip(*space))
            h = q.T @ kq
            theta, s = torch.linalg.eigh(0.5 * (h + h.T))
            kx, mx = kq @ s[:, :k], mq @ s[:, :k]
            lam = theta[:k]
            res = (kx - mx * lam).norm(dim=0) / (kx.norm(dim=0) + lam.abs() * mx.norm(dim=0))
            if bool((res <= RES_TOL).all()):
                return Modes(lam, q @ s[:, :k], step, True)
            if len(space) == blocks:  # restart from the lowest Ritz vectors
                keep = s[:, :b]
                space = [(q @ keep, mq @ keep, kq @ keep)]
    return Modes(lam, q @ s[:, :k], MAX_STEPS, False)
