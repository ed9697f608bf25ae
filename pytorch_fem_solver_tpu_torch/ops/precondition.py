"""Aggregate-block two-level preconditioner for the BSR system.

Counterpart of the aggblock subset of
``pytorch_fem_solver_tpu/ops/precondition.py``:

    M^{-1} r = D_g^{-1} r + P0 A_c^{-1} P0^T r,      A_c = P0^T A P0

with aggregates chosen as contiguous, equal-size index groups of the BSR
layout's spatial order, so restriction and prolongation are reshapes, the
coarse solve is one dense matvec against a precomputed inverse, and D_g is
the block diagonal over the same groups. The additive combination of SPD
terms is SPD, so CG theory applies unchanged. The other preconditioners of
the JAX package (affine/RBM, three-level, multiplicative, smoothed) are
queued in ROADMAP.md (A11).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a (shifted) SPD matrix via Cholesky.

    Non-SPD inputs fall back to the LU-based inverse, as in the JAX package
    (there a non-finite Cholesky factor selects the fallback; here the
    ``info`` flag of ``cholesky_ex`` does, since ``cholesky`` would raise).
    """
    n = a.shape[-1]
    chol, info = torch.linalg.cholesky_ex(a)
    if int(info) != 0 or not bool(torch.isfinite(chol).all()):
        return torch.linalg.inv(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return l_inv.T @ l_inv


def _prolong(z_c: torch.Tensor, g: int, n: int) -> torch.Tensor:
    """Piecewise-constant prolongation: repeat each coarse value g times."""
    return z_c[..., :, None].expand(*z_c.shape, g).reshape(*z_c.shape[:-1], n)


class BlockTwoLevel(NamedTuple):
    """M^{-1} = D^{-1} + P0 A_c^{-1} P0^T on a BSR-permuted system.

    The coarse solve is one dense (nc, nc) matvec against a precomputed
    inverse; the fine part is point Jacobi (``blk_inv`` None) or 8x8
    block-Jacobi.
    """

    inv_diag: torch.Tensor  # (n_pad,) point-Jacobi; unused when blk_inv set
    coarse_inv: torch.Tensor  # (nc, nc)
    g: int  # aggregate size (fine DOFs per coarse unknown)
    blk_inv: torch.Tensor | None = None  # (nb, k, k) block-Jacobi inverses

    def coarse_apply(self, r: torch.Tensor) -> torch.Tensor:
        """P0 A_c^{-1} P0^T r — restriction/prolongation are reshapes."""
        r_c = r.reshape(-1, self.g).sum(dim=-1)
        return _prolong(self.coarse_inv @ r_c, self.g, r.shape[0])

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        if self.blk_inv is None:
            fine = self.inv_diag * r
        else:
            k = self.blk_inv.shape[-1]
            fine = torch.einsum(
                "rij,rj->ri", self.blk_inv, r.reshape(-1, k)
            ).reshape(-1)
        return fine + self.coarse_apply(r)


def batched_small_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small SPD matrices via unrolled Gauss-Jordan.

    No pivoting — the inputs are SPD diagonal blocks of an assembled
    stiffness operator, where diagonal pivots are the stable choice. The
    same elimination as the JAX package, so float64 results agree to
    roundoff.
    """
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    aug = torch.cat([a, eye], dim=-1)  # (..., n, 2n)
    for k in range(n):
        pivot_row = aug[..., k, :] / aug[..., k, k : k + 1]
        aug = aug - aug[..., :, k : k + 1] * pivot_row[..., None, :]
        aug[..., k, :] = pivot_row
    return aug[..., n:]


MAX_COARSE = 4096  # dense coarse-level cap (inverse + per-iteration matvec)
BASE_AGGREGATE_BLOCKS = 4  # one aggregate = 4 blocks (32 DOFs) minimum


def _bounded_divisor_search(n_pad: int, base: int, mult0: int) -> int:
    """Smallest mult >= mult0 with (base*mult) | n_pad, degeneration-proof:
    the search is bounded at 4*mult0 and falls back downward, since an
    oversized dense coarse level beats a one-unknown one."""
    mult = max(mult0, 1)
    while n_pad % (base * mult) and mult < 4 * max(mult0, 1):
        mult += 1
    if n_pad % (base * mult):
        for cand in range(max(mult0, 1), 0, -1):
            if n_pad % (base * cand) == 0:
                return base * cand
        return base
    return base * mult


def default_aggregate_size(structure, max_coarse: int = MAX_COARSE) -> int:
    """Aggregate size keeping the dense coarse level at <= max_coarse
    (g = 32 up to ~130k DOFs, then whole multiples of 32)."""
    base = BASE_AGGREGATE_BLOCKS * structure.block
    mult0 = -(-structure.n_pad // (max_coarse * base))
    return _bounded_divisor_search(structure.n_pad, base, mult0)


def block_two_level_from_values(
    structure,
    values,
    diag,
    g: int | None = None,
    fine: str = "block_jacobi",
):
    """Numeric setup of the block two-level preconditioner.

    Every 8x8 value block lies inside one (coarse row, coarse col) pair, so
    the Galerkin coarse matrix is a segment-sum of per-block sums.

    Args:
      structure: ``ops.bsr.BSRStructure``.
      values: assembled ``(tier1, tier2)`` BSR values.
      diag: operator diagonal (n_pad,) (zeros on padded rows are safe).
      g: aggregate size; None picks ``default_aggregate_size``.
      fine: "block_jacobi" (8x8 diagonal-block inverses) or "jacobi".
    """
    block = structure.block
    if g is None:
        g = default_aggregate_size(structure)
    if g < block or g % block or structure.n_pad % g:
        raise ValueError(
            f"aggregate size {g} must be a multiple of block {block} "
            f"(>= {block}) and divide n_pad {structure.n_pad}"
        )
    bpa = g // block
    nc = structure.n_pad // g
    if nc > 8192:
        raise ValueError(
            f"coarse dimension n_pad/g = {nc} too large for the dense "
            f"two-level coarse solve (> 8192); use a larger aggregate size g"
        )
    nb, B = structure.bcols.shape

    v1, v2 = values
    bcols = structure.bcols.long()
    rows_c = (torch.arange(nb, device=bcols.device) // bpa)[:, None]
    bins = (rows_c * nc + bcols // bpa).reshape(-1)
    block_sums = v1.sum(dim=(-1, -2)).reshape(-1)
    coarse = torch.zeros(nc * nc, dtype=v1.dtype, device=v1.device)
    coarse.index_add_(0, bins, block_sums)
    if structure.heavy_rows.shape[0]:
        bins2 = (
            (structure.heavy_rows.long() // bpa)[:, None] * nc
            + structure.bcols2.long() // bpa
        ).reshape(-1)
        coarse.index_add_(0, bins2, v2.sum(dim=(-1, -2)).reshape(-1))
    coarse = coarse.reshape(nc, nc)
    coarse = 0.5 * (coarse + coarse.T)
    # aggregates made purely of padding rows are all-zero: the shift keeps
    # the inverse finite without affecting preconditioning quality
    shift_scale = torch.clamp(torch.trace(coarse) / nc, min=1.0)
    coarse_inv = spd_inverse(
        coarse + 1e-7 * shift_scale * torch.eye(nc, dtype=coarse.dtype, device=coarse.device)
    )

    safe = torch.where(diag != 0, diag, torch.ones_like(diag))
    blk_inv = None
    if fine == "block_jacobi":
        blk = v1[:, 0]  # the diagonal block always lives at tier-1 slot b=0
        blk_inv = batched_small_inv(_pin_zero_diagonal(blk))
    elif fine != "jacobi":
        raise ValueError(f"unknown fine smoother: {fine!r}")
    return BlockTwoLevel(inv_diag=1.0 / safe, coarse_inv=coarse_inv, g=g, blk_inv=blk_inv)


def _pin_zero_diagonal(d: torch.Tensor) -> torch.Tensor:
    """Padded rows carry all-zero diagonal blocks: pin their diagonals to
    identity so the batched inverse stays finite (their residual is
    identically zero, so the value never matters)."""
    n = d.shape[-1]
    zero_d = torch.diagonal(d, dim1=-2, dim2=-1) == 0
    eye = torch.eye(n, dtype=d.dtype, device=d.device)
    return d + eye * zero_d[:, None, :]


class AggBlockTwoLevel(NamedTuple):
    """M^{-1} = D_g^{-1} + P0 A_c^{-1} P0^T with aggregate-sized (gs x gs)
    diagonal-block smoothing.

    D_g is the block diagonal over contiguous gs-groups, so the smoother
    resolves all intra-aggregate coupling exactly and the coarse level only
    carries the inter-aggregate error. The apply is one batched (ns, gs, gs)
    matvec, aggregate sums, a dense coarse matvec and a broadcast.
    """

    inv_agg: torch.Tensor  # (ns, gs, gs) smoother diagonal-block inverses
    coarse_inv: torch.Tensor  # (nc, nc)
    g: int  # coarse aggregate size
    gs: int  # smoother block size (>= g allowed; both divide n_pad)

    def coarse_apply(self, r: torch.Tensor) -> torch.Tensor:
        r_c = r.reshape(-1, self.g).sum(dim=-1)
        return _prolong(self.coarse_inv @ r_c, self.g, r.shape[0])

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        fine = torch.einsum(
            "rij,rj->ri", self.inv_agg, r.reshape(-1, self.gs)
        ).reshape(-1)
        return fine + self.coarse_apply(r)


def build_agg_block_table(structure, g: int) -> np.ndarray:
    """(nc, bpa, bpa) host table: flat value-block id of each in-aggregate
    block pair (sentinel = one past the last block -> a zero block appended
    by the consumer)."""
    k = structure.block
    if g < k or g % k or structure.n_pad % g:
        raise ValueError(
            f"aggregate size {g} must be a multiple of block {k} (>= {k}) "
            f"and divide n_pad {structure.n_pad}"
        )
    bpa = g // k
    nc = structure.n_pad // g
    nb, B = structure.bcols.shape
    nh, B2 = structure.bcols2.shape
    sentinel = nb * B + nh * B2
    blk_id = structure.blk_id_host
    ubr = structure.ubr_host
    ubc = structure.ubc_host
    agg_r = ubr // bpa
    in_agg = (ubc // bpa) == agg_r
    table = np.full((nc, bpa, bpa), sentinel, dtype=np.int64)
    table[agg_r[in_agg], (ubr % bpa)[in_agg], (ubc % bpa)[in_agg]] = blk_id[
        in_agg
    ]
    return table


def agg_block_two_level_from_values(
    structure,
    values,
    diag,
    g: int | None = None,
    gs: int | None = None,
    table=None,
):
    """Numeric setup of the aggregate-block two-level M.

    Same Galerkin coarse level as ``block_two_level_from_values``; the fine
    smoother inverts the (gs, gs) aggregate diagonal blocks. ``gs`` defaults
    to ``min(g, 128)``. ``table`` may be precomputed with
    ``build_agg_block_table`` (host, value-independent).
    """
    base = block_two_level_from_values(structure, values, diag, g=g, fine="jacobi")
    g = base.g
    gs = min(g, 128) if gs is None else gs
    inv_agg = aggregate_block_inverses(structure, values, gs, table=table)
    return AggBlockTwoLevel(inv_agg=inv_agg, coarse_inv=base.coarse_inv, g=g, gs=gs)


def aggregate_block_inverses(structure, values, gs: int, table=None):
    """(ns, gs, gs) inverses of the aggregate diagonal blocks."""
    if gs % structure.block or structure.n_pad % gs:
        raise ValueError(
            f"smoother block size {gs} must be a multiple of "
            f"block {structure.block} and divide n_pad {structure.n_pad}"
        )
    k = structure.block
    if table is None:
        table = build_agg_block_table(structure, gs)
    v1, v2 = values
    flat = torch.cat(
        [
            v1.reshape(-1, k * k),
            v2.reshape(-1, k * k),
            torch.zeros((1, k * k), dtype=v1.dtype, device=v1.device),
        ],
        dim=0,
    )
    rows = flat[torch.as_tensor(table, device=v1.device)]  # (ns, bpa, bpa, k*k)
    bpa = gs // k
    blocks = rows.reshape(-1, bpa, bpa, k, k)
    D = blocks.permute(0, 1, 3, 2, 4).reshape(-1, gs, gs)
    return batched_small_inv(_pin_zero_diagonal(D))
