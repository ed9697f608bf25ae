"""Plain P1 linear elasticity: the reference of ``problems/elasticity_p1.py``.

    -div sigma(u) = f,  sigma(u) = E(x) (2 mu eps(u) + lambda div(u) I),

with mu = 1 / (2 (1 + nu)), lambda = nu / ((1 + nu) (1 - 2 nu)) and
u = 0 (every component) on the Dirichlet nodes, worked out from scratch on
glued tetrahedra (``p1.Glued``): the P1 gradients from each cell's vertex
coordinates, the degree-2 tetrahedral rule of ``p1.RULES`` for E and f,
the 12 x 12 element matrices of the Lame form

    K[(a, i), (b, j)] = |T| Ebar (mu (delta_ij grad phi_a . grad phi_b
                        + d_j phi_a d_i phi_b) + lambda d_i phi_a d_j phi_b),

(Ebar the rule's mean of E on the cell, exact since the gradients are
constant) and the element loads, their sum into a CSR matrix of the
interior DOFs (node-major, component-minor: DOF 3 i + c), and a CG solve
preconditioned by the inverses of the nodal 3 x 3 diagonal blocks, in
float64, to a relative residual of 1e-13. Plain PyTorch in blocks of
cells; it imports nothing of the program under test, takes nothing that it
made, and shares no code with its vector basis or its rigid-body-mode
preconditioner. ``solve(..., control=...)`` is ``p1``'s: ``"tf32"`` rounds
the operator and the load to TF32 and solves in float64, ``"float32"``
rounds them to float32 and solves in float32 to 1e-6.

Departures from the published problem (the FEniCS performance test's
elasticity problem: vector P1 tetrahedra on the unit cube, a constant
Young's modulus, a body force, part of the boundary clamped, CG with
smoothed-aggregation AMG and the rigid-body near-nullspace):

* E(x) is the traffic's log-normal field, a new sample each request, with
  a mean scale of 1: u scales as 1 / E, so the source's absolute E only
  rescales the answer;
* the body force is the configuration's load module (``loads/``) plus the
  traffic's load field on each component, not the source's;
* every boundary node is clamped;
* nu is the configuration's (0.3);
* the preconditioner is nodal block Jacobi, not AMG: the reference is
  judged by its residual, not by its speed.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import torch

from .p1 import BLOCK, MAXITER, RULES, Glued, round_tf32

#: components of the displacement
C = 3


def lame(nu: float) -> tuple[float, float]:
    """(mu, lambda) of a unit Young's modulus and Poisson's ratio ``nu``."""
    return 1.0 / (2.0 * (1.0 + nu)), nu / ((1.0 + nu) * (1.0 - 2.0 * nu))


class Reference:
    """The glued tetrahedra's geometry and the CSR pattern of the interior
    DOFs, built once on ``device``; ``solve`` per pair of fields."""

    def __init__(self, glued: Glued, device, degree: int = 2, nu: float = 0.3):
        self.device = dev = torch.device(device)
        self.glued = glued
        self.mu, self.lam = lame(nu)
        cells = np.asarray(glued.cells, dtype=np.int64)
        if cells.shape[1] != 4 or (4, degree) not in RULES:
            raise ValueError(f"no tetrahedral rule of degree {degree} for cells of "
                             f"{cells.shape[1]} nodes")
        interior = ~np.asarray(glued.dirichlet, dtype=bool)
        n = self.n_nodes = int(interior.sum())
        number = np.full(len(interior), -1, dtype=np.int64)
        number[interior] = np.arange(n)
        self.number = number
        self.cells = torch.as_tensor(cells, device=dev)
        self.coords = torch.as_tensor(np.asarray(glued.cell_coords, dtype=np.float64), device=dev)
        lam, w = RULES[4, degree]
        self.lam_q = torch.as_tensor(lam, device=dev)  # (q, 4)
        self.w = torch.as_tensor(w, device=dev)  # (q,)

        # the interior node pairs that share a cell, CSR order
        num = torch.as_tensor(number, device=dev)[self.cells]  # (T, 4)
        rows = num[:, :, None].expand(-1, 4, 4)
        cols = num[:, None, :].expand(-1, 4, 4)
        keep = (rows >= 0) & (cols >= 0)
        uniq, pair = torch.unique(rows[keep] * n + cols[keep], return_inverse=True)
        row_n, col_n = uniq // n, uniq % n
        crow_n = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                            torch.bincount(row_n, minlength=n).cumsum(0)])
        deg = crow_n[1:] - crow_n[:-1]
        # node pair s of row i and column j holds the 9 entries (3 i + c, 3 j + d)
        # at 9 crow_n[i] + 3 deg_i c + 3 (s - crow_n[i]) + d
        c = torch.arange(C, device=dev)
        start = 9 * crow_n[row_n]
        self.pos = (start[:, None, None] + 3 * deg[row_n][:, None, None] * c[None, :, None]
                    + 3 * (torch.arange(uniq.numel(), device=dev) - crow_n[row_n])[:, None, None]
                    + c[None, None, :])  # (pairs, 3, 3)
        self.nnz = 9 * int(uniq.numel())
        self.col = torch.empty(self.nnz, dtype=torch.int64, device=dev)
        self.col[self.pos.reshape(-1)] = (3 * col_n[:, None, None] + c[None, None, :]).expand(
            -1, C, C).reshape(-1)
        self.crow = torch.cat([(9 * crow_n[:-1, None] + 3 * deg[:, None] * c[None, :]).reshape(-1),
                               torch.tensor([self.nnz], device=dev)])
        self.pair = torch.full((cells.shape[0], 4, 4), -1, dtype=torch.int64, device=dev)
        self.pair[keep] = pair
        self.diagonal = self.pos[torch.nonzero(row_n == col_n)[:, 0]]  # (n, 3, 3), by node
        self.load_rows = torch.where(num[:, :, None] >= 0, C * num[:, :, None] + c, C * n)

    def _elements(self, E: Callable, load: Callable, b0: int, b1: int):
        """Element matrices (B, 4, 3, 4, 3) and loads (B, 4, 3) of cells
        ``b0:b1``, float64."""
        p = self.coords[b0:b1]  # (B, 4, 3)
        edges = p[:, 1:] - p[:, :1]
        gram = edges @ edges.mT
        measure = torch.sqrt(torch.linalg.det(gram)) / 6.0
        g_rest = torch.linalg.solve(gram, edges)  # grads of lambda_1..3
        G = torch.cat([-g_rest.sum(1, keepdim=True), g_rest], dim=1)  # (B, 4, 3)
        xq = torch.einsum("qk,bkd->bqd", self.lam_q, p)  # (B, q, 3)
        ebar = (E(xq) * self.w).sum(-1)
        eye = torch.eye(C, dtype=G.dtype, device=G.device)
        k = (self.mu * (torch.einsum("xak,xbk,ij->xaibj", G, G, eye)
                        + torch.einsum("xaj,xbi->xaibj", G, G))
             + self.lam * torch.einsum("xai,xbj->xaibj", G, G))
        mats = (ebar * measure)[:, None, None, None, None] * k
        loads = measure[:, None, None] * torch.einsum("bqi,q,qa->bai", load(xq), self.w,
                                                      self.lam_q)
        return mats, loads

    def assemble(self, E: Callable, load: Callable):
        """The interior operator's CSR values (nnz,) and the load (3 n,),
        float64. ``E`` maps points (..., 3) to (...), ``load`` to (..., 3)."""
        values = torch.zeros(self.nnz, dtype=torch.float64, device=self.device)
        b = torch.zeros(C * self.n_nodes + 1, dtype=torch.float64, device=self.device)
        for b0 in range(0, self.cells.shape[0], BLOCK):
            b1 = min(b0 + BLOCK, self.cells.shape[0])
            mats, loads = self._elements(E, load, b0, b1)
            pair = self.pair[b0:b1]  # (B, 4, 4)
            keep = pair >= 0
            values.index_add_(0, self.pos[pair[keep]].reshape(-1),
                              mats.permute(0, 1, 3, 2, 4)[keep].reshape(-1))
            b.index_add_(0, self.load_rows[b0:b1].reshape(-1), loads.reshape(-1))
        return values, b[:-1]

    def matrix(self, values: torch.Tensor) -> torch.Tensor:
        n = C * self.n_nodes
        with warnings.catch_warnings():  # PyTorch's notice that sparse CSR is in beta
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.crow, self.col, values, (n, n),
                                           check_invariants=False)

    def solve(self, E: Callable, load: Callable, control: str | None = None):
        """The displacement at every node (N, 3), float64 (zero on the
        Dirichlet nodes), and the CG iteration count."""
        values, b = self.assemble(E, load)
        dtype, tol = torch.float64, 1e-13
        if control == "tf32":
            values, b = round_tf32(values).double(), round_tf32(b).double()
        elif control == "float32":
            dtype, tol = torch.float32, 1e-6
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        values, b = values.to(dtype), b.to(dtype)
        inv = torch.linalg.inv(values[self.diagonal])  # (n, 3, 3) nodal blocks
        x, iters = cg(self.matrix(values), b, inv, tol)
        u = torch.zeros(len(self.glued.dirichlet), C, dtype=torch.float64, device=self.device)
        u[torch.as_tensor(self.number >= 0, device=self.device)] = x.double().reshape(-1, C)
        return u, iters


def cg(A: torch.Tensor, b: torch.Tensor, inv_blocks: torch.Tensor, tol: float,
       maxiter: int = MAXITER, every: int = 25):
    """CG on the CSR matrix ``A``, preconditioned by the nodal block
    inverses ``inv_blocks`` (n, 3, 3), to ||r|| <= tol ||b|| in ``b``'s
    dtype, reading the residual every ``every`` iterations."""

    def precondition(r):
        return (inv_blocks @ r.reshape(-1, C, 1)).reshape(-1)

    x = torch.zeros_like(b)
    r = b.clone()
    z = precondition(r)
    p = z.clone()
    rz = torch.dot(r, z)
    stop = tol * torch.linalg.norm(b)
    k = 0
    while k < maxiter:
        ap = A @ p
        alpha = rz / torch.dot(p, ap)
        x += alpha * p
        r -= alpha * ap
        k += 1
        if k % every == 0 and bool(torch.linalg.norm(r) <= stop):
            break
        z = precondition(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, k

