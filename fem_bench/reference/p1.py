"""Plain P1 finite elements: the benchmark's reference solve.

Given glued simplices (triangles embedded in 3D, or tetrahedra; each
cell's geometry from its own vertex coordinates, its unknowns on the glued
nodes), the Dirichlet nodes and the two fields, this works out
-div(kappa grad u) = f with u = 0 on the Dirichlet nodes from scratch: P1
gradients from the vertex coordinates, the configuration's symmetric
quadrature rule of the simplex (degree 2: 3 points on a triangle, 4 on a
tetrahedron; degree 4 on a triangle: Dunavant's 6 points), the element
matrices and loads, their sum into a CSR matrix of the interior nodes, and a
Jacobi-preconditioned conjugate-gradient solve in float64 to a relative
residual of 1e-13. Plain PyTorch in float64, in blocks of cells; it imports
nothing of the program under test and takes nothing that it made.

``Reference.solve(..., control=...)`` computes the same solve in a lower
precision, the control that the comparison must reject: ``"tf32"`` rounds
the operator and the load to TF32's 10-bit significand, ``"float32"``
assembles and solves in float32 with CG stopping at 1e-6.
"""

from __future__ import annotations

import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

#: cells per block of the element computations
BLOCK = 1 << 18
#: the most CG iterations of a reference solve
MAXITER = 100_000

_TET_A = (5.0 - math.sqrt(5.0)) / 20.0


def _orbits(*orbits) -> tuple[np.ndarray, np.ndarray]:
    """A triangle rule from (a, weight) orbits: the 3 barycentric points
    with two coordinates a and the third 1 - 2a."""
    lam = [np.roll([1.0 - 2.0 * a, a, a], r) for a, _ in orbits for r in range(3)]
    return np.array(lam), np.array([w for _, w in orbits for _ in range(3)])


#: (nodes a cell, degree) -> barycentric points and weights (summing to 1);
#: the degree-4 triangle rule is Dunavant's (Int. J. Numer. Meth. Eng. 21
#: (1985) 1129-1148, table of degree 4)
RULES = {
    (3, 2): _orbits((1 / 6, 1 / 3)),
    (3, 4): _orbits((0.091576213509771, 0.109951743655322),
                    (0.445948490915965, 0.223381589678011)),
    (4, 2): (np.full((4, 4), _TET_A) + np.eye(4) * (1.0 - 4.0 * _TET_A), np.full(4, 0.25)),
}


class Glued(NamedTuple):
    """A mesh input glued into one P1 problem."""

    cell_coords: np.ndarray  # (T, k, 3) float64, each cell's own vertex coordinates
    cells: np.ndarray  # (T, k) node ids, k = 3 (triangles) or 4 (tetrahedra)
    dirichlet: np.ndarray  # (N,) bool, u = 0 there
    vertex_node: np.ndarray  # (n_input_vertices,) node of each input vertex


def field_function(spec, params: np.ndarray, device) -> Callable:
    """The field of ``spec`` (``fem_bench.fields.FieldSpec``) with
    ``params`` as a function of points (..., 3) -> (...), in float64."""
    w = torch.as_tensor(np.asarray(params)[:, :3], dtype=torch.float64, device=device)
    phi = torch.as_tensor(np.asarray(params)[:, 3], dtype=torch.float64, device=device)

    def field(x: torch.Tensor) -> torch.Tensor:
        g = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
        if spec.sigma != 0.0:
            g = math.sqrt(2.0 / spec.modes) * torch.cos(x @ w.T + phi).sum(-1)
        z = spec.mean + spec.sigma * g
        return torch.exp(z) if spec.transform == "exp" else z

    return field


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (float32 with a 10-bit significand, to nearest,
    ties away from zero), returned in float32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class Reference:
    """The glued problem's element geometry and interior CSR pattern, built
    once on ``device`` for the quadrature of ``degree``; ``solve`` per pair
    of fields."""

    def __init__(self, glued: Glued, device, degree: int = 2):
        self.device = torch.device(device)
        self.glued = glued
        cells = np.asarray(glued.cells, dtype=np.int64)
        k = cells.shape[1]
        if (k, degree) not in RULES:
            raise ValueError(f"no rule of degree {degree} for cells of {k} nodes")
        n = len(glued.dirichlet)
        interior = ~np.asarray(glued.dirichlet, dtype=bool)
        self.n_interior = int(interior.sum())
        number = np.full(n, -1, dtype=np.int64)
        number[interior] = np.arange(self.n_interior)
        self.number = number
        dev = self.device
        self.cells = torch.as_tensor(cells, device=dev)
        self.coords = torch.as_tensor(np.asarray(glued.cell_coords, dtype=np.float64), device=dev)
        lam, w = RULES[k, degree]
        self.lam = torch.as_tensor(lam, device=dev)  # (q, k)
        self.w = torch.as_tensor(w, device=dev)  # (q,)

        # the interior pattern: one slot per (row, col) pair, CSR order
        num = torch.as_tensor(number, device=dev)[self.cells]  # (T, k)
        rows = num[:, :, None].expand(-1, k, k).reshape(-1)
        cols = num[:, None, :].expand(-1, k, k).reshape(-1)
        keep = (rows >= 0) & (cols >= 0)
        self.keep = keep
        keys = rows[keep] * self.n_interior + cols[keep]
        uniq, self.slot = torch.unique(keys, return_inverse=True)
        self.nnz = int(uniq.numel())
        self.col = (uniq % self.n_interior).to(torch.int64)
        row = uniq // self.n_interior
        counts = torch.bincount(row, minlength=self.n_interior)
        self.crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), counts.cumsum(0)])
        self.diagonal = torch.nonzero(row == self.col)[:, 0]  # slots of (i, i), in row order
        self.load_rows = num.reshape(-1)

    def _elements(self, kappa: Callable, load: Callable):
        """Element matrices (T, k, k) and loads (T, k), float64, the fields
        evaluated at the quadrature points in blocks of cells."""
        mats, loads = [], []
        for c0 in range(0, self.cells.shape[0], BLOCK):
            p = self.coords[c0:c0 + BLOCK]  # (B, k, 3)
            edges = p[:, 1:] - p[:, :1]  # (B, k-1, 3)
            gram = edges @ edges.mT
            measure = torch.sqrt(torch.linalg.det(gram)) / math.factorial(edges.shape[1])
            g_rest = torch.linalg.solve(gram, edges)  # grads of lambda_1..: (B, k-1, 3)
            grads = torch.cat([-g_rest.sum(1, keepdim=True), g_rest], dim=1)  # (B, k, 3)
            xq = torch.einsum("qk,bkd->bqd", self.lam, p)  # (B, q, 3)
            kq = kappa(xq)  # (B, q)
            fq = load(xq)
            kbar = (kq * self.w).sum(-1)
            mats.append((kbar * measure)[:, None, None] * (grads @ grads.mT))
            loads.append(measure[:, None] * torch.einsum("bq,q,qk->bk", fq, self.w, self.lam))
        return torch.cat(mats), torch.cat(loads)

    def assemble(self, kappa: Callable, load: Callable):
        """The interior operator's CSR values (nnz,) and the load (n,), float64."""
        mats, loads = self._elements(kappa, load)
        values = torch.zeros(self.nnz, dtype=torch.float64, device=self.device)
        values.index_add_(0, self.slot, mats.reshape(-1)[self.keep])
        b = torch.zeros(self.n_interior + 1, dtype=torch.float64, device=self.device)
        rows = torch.where(self.load_rows >= 0, self.load_rows, self.n_interior)
        b.index_add_(0, rows, loads.reshape(-1))
        return values, b[:-1]

    def matrix(self, values: torch.Tensor) -> torch.Tensor:
        n = self.n_interior
        with warnings.catch_warnings():  # PyTorch's notice that sparse CSR is in beta
            warnings.simplefilter("ignore", UserWarning)
            return torch.sparse_csr_tensor(self.crow, self.col, values, (n, n),
                                           check_invariants=False)

    def solve(self, kappa: Callable, load: Callable, control: str | None = None):
        """The solution at every node (N,), float64 (zero on the Dirichlet
        nodes), and the CG iteration count; ``control`` as in the module
        docstring."""
        values, b = self.assemble(kappa, load)
        dtype, tol = torch.float64, 1e-13
        if control == "tf32":
            values, b = round_tf32(values).double(), round_tf32(b).double()
        elif control == "float32":
            values, b, dtype, tol = values.float(), b.float(), torch.float32, 1e-6
        elif control is not None:
            raise ValueError(f"unknown control {control!r}")
        values, b = values.to(dtype), b.to(dtype)
        x, iters = cg(self.matrix(values), b, values[self.diagonal], tol)
        u = torch.zeros(len(self.glued.dirichlet), dtype=torch.float64, device=self.device)
        u[torch.as_tensor(self.number >= 0, device=self.device)] = x.double()
        return u, iters


def cg(A: torch.Tensor, b: torch.Tensor, diag: torch.Tensor, tol: float,
       maxiter: int = MAXITER, every: int = 25):
    """Jacobi-preconditioned CG on the CSR matrix ``A`` with diagonal
    ``diag`` to ||r|| <= tol ||b|| in ``b``'s dtype, reading the residual
    every ``every`` iterations."""
    inv_d = 1.0 / diag
    x = torch.zeros_like(b)
    r = b.clone()
    z = inv_d * r
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
        z = inv_d * r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x, k
