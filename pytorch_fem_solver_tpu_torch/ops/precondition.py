"""Aggregate-block two-level preconditioner for the BSR system.

Counterpart of the aggblock subset of
``pytorch_fem_solver_tpu/ops/precondition.py``:

    M^{-1} r = D_g^{-1} r + P0 A_c^{-1} P0^T r,      A_c = P0^T A P0

with aggregates chosen as contiguous, equal-size index groups of the BSR
layout's spatial order, so restriction and prolongation are reshapes, the
coarse solve is one dense matvec against a precomputed inverse, and D_g is
the block diagonal over the same groups. The additive combination of SPD
terms is SPD, so CG theory applies unchanged.

The affine / rigid-body-mode family follows (``AffineTwoLevelStructure``
host tables with W from NumPy's float64 QR, ``affine_two_level_from_values``
per assembly): the coarse space of vector bases, which
``auto_preconditioner`` picks for ``n_components >= 2``. Then the ELL
family: the smoothed two-level preconditioner of the hybrid-ELL operator
(``TwoLevelStructure`` host tables built once, ``two_level_from_values``
per assembly: gather-only restriction and prolongation and a dense coarse
inverse) and the plain block two-level ``build_two_level``. The
three-level and multiplicative families of the JAX package are queued in
ROADMAP.md (A6), and so are its reduced-precision operands (B6).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from .sparse import ELLStructure, invert_scatter_map


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


def _apply_fine(blk_inv, inv_diag, r):
    """Fine smoother application: batched block-Jacobi or point Jacobi."""
    if blk_inv is None:
        return inv_diag * r
    k = blk_inv.shape[-1]
    return torch.einsum("rij,rj->ri", blk_inv, r.reshape(-1, k)).reshape(-1)


class TwoLevelPreconditioner(NamedTuple):
    """M^{-1} = D^{-1} + P0 A_c^{-1} P0^T over contiguous index blocks of
    ``block`` unknowns (``build_two_level``)."""

    inv_diag: torch.Tensor  # (n,)
    coarse_inv: torch.Tensor  # (nb, nb) dense inverse of R^T A R
    block: int
    n: int
    n_pad: int

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        fine = self.inv_diag * r
        r_pad = torch.cat([r, r.new_zeros(self.n_pad - self.n)])
        r_coarse = r_pad.reshape(-1, self.block).sum(dim=-1)
        z_pad = _prolong(self.coarse_inv @ r_coarse, self.block, self.n_pad)
        return fine + z_pad[: self.n]


def spatial_aggregates(coords: np.ndarray, leaf: int = 32) -> np.ndarray:
    """Cluster points into spatial aggregates of <= leaf by coordinate
    bisection (stable argsort along the widest axis). Returns (n,)
    aggregate ids (contiguous, 0..n_agg-1)."""
    coords = np.asarray(coords)
    n = coords.shape[0]
    agg = np.zeros(n, dtype=np.int64)
    counter = [0]

    def bisect(idx):
        if len(idx) <= leaf:
            agg[idx] = counter[0]
            counter[0] += 1
            return
        spans = coords[idx].max(0) - coords[idx].min(0)
        ax = int(np.argmax(spans))
        order = idx[np.argsort(coords[idx, ax], kind="stable")]
        half = len(order) // 2
        bisect(order[:half])
        bisect(order[half:])

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 64 + int(2 * np.log2(max(n, 2)))))
    try:
        bisect(np.arange(n))
    finally:
        sys.setrecursionlimit(old_limit)
    return agg


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
        return _apply_fine(self.blk_inv, self.inv_diag, r) + self.coarse_apply(r)


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
AFFINE_MAX_VECTORS = 4  # [1, x, y, z]: m = 1 + d <= 4 (the BSR padding's sizing)


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
    blk_inv = _fine_block_smoother(v1, fine)
    return BlockTwoLevel(inv_diag=1.0 / safe, coarse_inv=coarse_inv, g=g, blk_inv=blk_inv)


def _fine_block_smoother(v1, fine: str = "block_jacobi"):
    """Diagonal-block inverses of the fine smoother (None for point
    Jacobi). The diagonal block of a block-row always lives at tier-1 slot
    b=0; padded rows' all-zero blocks are pinned to identity."""
    if fine == "jacobi":
        return None
    if fine != "block_jacobi":
        raise ValueError(f"unknown fine smoother: {fine!r}")
    return batched_small_inv(_pin_zero_diagonal(v1[:, 0]))


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
    to ``min(g, 128)``. ``table`` may be precomputed: the device tensor of
    ``build_agg_block_table`` (value-independent).
    """
    base = block_two_level_from_values(structure, values, diag, g=g, fine="jacobi")
    g = base.g
    gs = min(g, 128) if gs is None else gs
    inv_agg = aggregate_block_inverses(structure, values, gs, table=table)
    # contiguous, as the fused tail's kernels read them (the Gauss-Jordan
    # result is a column slice of the augmented matrix)
    return AggBlockTwoLevel(
        inv_agg=inv_agg.contiguous(),
        coarse_inv=base.coarse_inv.contiguous(),
        g=g,
        gs=gs,
    )


def aggregate_block_inverses(structure, values, gs: int, table=None):
    """(ns, gs, gs) inverses of the aggregate diagonal blocks."""
    if gs % structure.block or structure.n_pad % gs:
        raise ValueError(
            f"smoother block size {gs} must be a multiple of "
            f"block {structure.block} and divide n_pad {structure.n_pad}"
        )
    k = structure.block
    v1, v2 = values
    if table is None:
        table = torch.as_tensor(build_agg_block_table(structure, gs), device=v1.device)
    flat = torch.cat(
        [
            v1.reshape(-1, k * k),
            v2.reshape(-1, k * k),
            torch.zeros((1, k * k), dtype=v1.dtype, device=v1.device),
        ],
        dim=0,
    )
    rows = flat[table]  # (ns, bpa, bpa, k*k)
    bpa = gs // k
    blocks = rows.reshape(-1, bpa, bpa, k, k)
    D = blocks.permute(0, 1, 3, 2, 4).reshape(-1, gs, gs)
    return batched_small_inv(_pin_zero_diagonal(D))


# -- the affine / rigid-body-mode family ----------------------------------------


class AffineTwoLevelStructure(NamedTuple):
    """Host-built tables of the affine-coarse two-level preconditioner.

    Coarse space: per contiguous aggregate of ``g`` fine DOFs, the m = 1+k
    vectors [1, columns...] (the coordinates [x, y, (z)] by default, or
    given mode columns such as the rigid body modes), centred and scaled
    per aggregate and orthonormalised per aggregate by NumPy's batched QR
    in float64 on the host, as in the JAX package (so W carries JAX's
    column signs). Transfers stay reshape + einsum.
    """

    W: torch.Tensor  # (na, g, m) orthonormal per-aggregate basis
    Wb: torch.Tensor  # (nb, block, m) the same rows grouped per 8-block
    bins1: torch.Tensor  # (nb*B,) aggregate-pair segment id per tier-1 block
    bins2: torch.Tensor  # (nh*B2,) same for spilled tier-2 blocks
    na: int
    g: int
    m: int


class AffineTwoLevel(NamedTuple):
    """M^{-1} = S + P (P^T A P)^{-1} P^T with P the per-aggregate W and S
    the 8x8 block-Jacobi (``blk_inv``), point-Jacobi or, with ``inv_agg``,
    the (gs x gs) aggregate-block smoother."""

    inv_diag: torch.Tensor
    coarse_inv: torch.Tensor  # (na*m, na*m)
    W: torch.Tensor  # (na, g, m)
    blk_inv: torch.Tensor | None = None
    inv_agg: torch.Tensor | None = None  # (ns, gs, gs) aggregate smoother
    gs: int = 0

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        na, g, m = self.W.shape
        r_c = torch.einsum("agm,ag->am", self.W, r.reshape(na, g)).reshape(-1)
        z_c = self.coarse_inv @ r_c
        z = torch.einsum("agm,am->ag", self.W, z_c.reshape(na, m)).reshape(-1)
        if self.inv_agg is not None:
            fine = torch.einsum(
                "rij,rj->ri", self.inv_agg, r.reshape(-1, self.gs)
            ).reshape(-1)
        else:
            fine = _apply_fine(self.blk_inv, self.inv_diag, r)
        return fine + z


def default_affine_aggregate_size(
    structure, m: int = AFFINE_MAX_VECTORS, max_coarse: int = MAX_COARSE
):
    """Aggregate size for the affine space: na*m <= max_coarse, where the
    divisor search allows (it falls back downward, so na*m may exceed the
    cap: JAX's behaviour, kept)."""
    base = BASE_AGGREGATE_BLOCKS * structure.block
    mult0 = -(-structure.n_pad * m // (max_coarse * base))
    return _bounded_divisor_search(structure.n_pad, base, mult0)


def elasticity_rbm_modes(
    coords: np.ndarray,
    components: np.ndarray,
    include_stretch: bool = False,
) -> np.ndarray:
    """Per-DOF rigid-body-mode columns for an interleaved vector basis
    (``basis.VectorBasis``): the (n, k) non-constant columns to pass to
    ``build_affine_two_level_structure(modes=...)``, which prepends the
    ones column.

    * component indicators for c = 1..nc-1 (translations),
    * one rotation column per coordinate pair (a, b): ``-x_b`` on
      component-a DOFs, ``x_a`` on component-b DOFs,
    * with ``include_stretch``: per-component coordinate columns.

    Args:
      coords: (n, d) coordinates of the (interior) DOFs.
      components: (n,) component index of each DOF (``inner_ids % nc``).
    """
    coords = np.asarray(coords, dtype=np.float64)
    components = np.asarray(components)
    n, d = coords.shape
    nc = int(components.max(initial=0)) + 1
    cols = []
    for c in range(1, nc):
        cols.append((components == c).astype(np.float64))
    for a in range(min(nc, d)):
        for b in range(a + 1, min(nc, d)):
            col = np.zeros(n)
            sel_a = components == a
            sel_b = components == b
            col[sel_a] = -coords[sel_a, b]
            col[sel_b] = coords[sel_b, a]
            cols.append(col)
    if include_stretch:
        for c in range(nc):
            sel = components == c
            for j in range(d):
                col = np.zeros(n)
                col[sel] = coords[sel, j]
                cols.append(col)
    return np.stack(cols, axis=1)


def build_affine_two_level_structure(
    structure, coords, g: int | None = None, modes: np.ndarray | None = None,
    *, dtype: torch.dtype | None = None,
) -> AffineTwoLevelStructure:
    """Host-side W (float64 QR) and aggregate-pair bins, value-independent,
    moved to the structure's device once: W in ``dtype`` (default
    ``config.default_dtype()``), the bins int32 as in the JAX package.

    Args:
      structure: the BSR layout.
      coords: (n_inner, d) coordinates of the interior DOFs in ORIGINAL
        reduced order (the array the spatial ordering was built from).
      modes: optional (n_inner, k) columns replacing the coordinate
        columns, each centred and scaled per aggregate; the constant column
        is always prepended (``elasticity_rbm_modes`` for vector problems).
    """
    coords = np.asarray(coords) if modes is None else np.asarray(modes)
    d = coords.shape[1]
    m = 1 + d
    if g is None:
        g = default_affine_aggregate_size(structure, m=m)
    if g % structure.block or structure.n_pad % g:
        raise ValueError(
            f"affine aggregate size {g} must be a multiple of "
            f"{structure.block} and divide n_pad {structure.n_pad}"
        )
    n_pad = structure.n_pad
    na = n_pad // g

    cp = np.zeros((n_pad, d), dtype=np.float64)
    cp[: structure.n_inner] = coords[structure.perm]
    X = cp.reshape(na, g, d)
    X = X - X.mean(axis=1, keepdims=True)
    span = np.maximum(np.abs(X).max(axis=1, keepdims=True), 1e-12)
    cols = np.concatenate([np.ones((na, g, 1)), X / span], axis=-1)
    # batched reduced QR; rank-deficient aggregates get arbitrary
    # orthonormal tail columns, harmless extra directions of an SPD coarse
    # space. NumPy's, not torch.linalg.qr: the column signs are JAX's.
    W, _ = np.linalg.qr(cols)

    block = structure.block
    gb = g // block
    nb, B = structure.bcols.shape
    bcols = structure.bcols.cpu().numpy().astype(np.int64)
    rows_c = np.repeat(np.arange(nb) // gb, B)
    bins1 = rows_c * na + (bcols // gb).reshape(-1)
    heavy = structure.heavy_rows.cpu().numpy().astype(np.int64)
    bcols2 = structure.bcols2.cpu().numpy().astype(np.int64)
    if heavy.size:
        bins2 = (
            np.repeat(heavy // gb, bcols2.shape[1]) * na
            + (bcols2 // gb).reshape(-1)
        )
    else:
        bins2 = np.zeros((0,), dtype=np.int64)

    device = structure.bcols.device
    Wt = torch.as_tensor(W, dtype=dtype or config.default_dtype(), device=device)

    def index(a):
        return torch.as_tensor(
            a.astype(np.int32), dtype=config.index_dtype(), device=device
        )

    return AffineTwoLevelStructure(
        W=Wt,
        Wb=Wt.reshape(nb, block, m),
        bins1=index(bins1),
        bins2=index(bins2),
        na=int(na),
        g=int(g),
        m=int(m),
    )


def get_affine_two_level_structure(
    basis,
    structure,
    g: int | None = None,
    rbm: bool = False,
    mode_kind: str | None = None,
) -> AffineTwoLevelStructure:
    """Cached-per-basis affine / rigid-body-mode / component coarse tables,
    W in the basis's dtype.

    ``mode_kind`` selects the per-aggregate column set (``rbm=True`` is a
    shorthand for ``mode_kind="rbm"``):

    * ``"affine"`` (default): [1, x, y, (z)], scalar problems;
    * ``"rbm"``: constants + per-component translations + rotations
      (``elasticity_rbm_modes``), coupled vector problems (elasticity);
    * ``"components"``: constants + component indicators only (m =
      n_components), the near-nullspace of a component-decoupled vector
      operator.
    """
    if mode_kind is None:
        mode_kind = "rbm" if rbm else "affine"
    if mode_kind not in ("affine", "rbm", "components"):
        raise ValueError(f"unknown mode_kind: {mode_kind!r}")
    cache = getattr(basis, "_affine_two_level_structures", None)
    if cache is None:
        cache = {}
        basis._affine_two_level_structures = cache
    key = (structure.nb, structure.bcols.shape[1],
           structure.heavy_rows.shape[0], g, mode_kind)
    ast = cache.get(key)
    if ast is None:
        inner = basis._as_host_index(basis._basis_parameters["inner_dofs"])
        coords = basis._coords4global_dofs.cpu().numpy()[inner]
        modes = None
        if mode_kind in ("rbm", "components"):
            nc = int(getattr(basis, "n_components", 1))
            if nc < 2:
                raise ValueError(
                    f"{mode_kind} coarse space requires a vector basis "
                    "(n_components >= 2)"
                )
            if mode_kind == "rbm":
                modes = elasticity_rbm_modes(coords, inner % nc)
            else:
                comp = inner % nc
                modes = np.stack(
                    [(comp == c).astype(np.float64) for c in range(1, nc)],
                    axis=1,
                )
        ast = build_affine_two_level_structure(
            structure, coords, g=g, modes=modes, dtype=basis.dtype
        )
        cache[key] = ast
    return ast


def affine_two_level_from_values(
    ast: AffineTwoLevelStructure,
    structure,
    values,
    diag,
    fine: str = "block_jacobi",
    gs: int | None = None,
    agg_table=None,
) -> AffineTwoLevel:
    """Numeric setup of the affine-coarse two-level M, on the device.

    Galerkin coarse matrix per aggregate pair:
        A_c[I, J] = sum over blocks (r, b) with r in I, bcols[r,b] in J of
                    Wb[r]^T A[r,b] Wb[bcols[r,b]]
    two small einsums over the tier values and one (m, m)-row segment sum
    (``index_add_``; on the card its float atomics vary the summation
    order of A_c). Symmetrised, shifted by 1e-7 max(trace / (na m), 1) and
    inverted by Cholesky.

    ``fine="agg_block"`` swaps the 8x8 block-Jacobi smoother for the
    (gs x gs) aggregate diagonal-block inverses of ``AggBlockTwoLevel``;
    ``gs`` defaults to min(default_aggregate_size, 128), ``agg_table`` to
    the device table of ``build_agg_block_table``.
    """
    v1, v2 = values
    na, m = ast.na, ast.m
    Wb = ast.Wb.to(v1.dtype)

    Wc = Wb[structure.bcols.long()]  # (nb, B, block, m) row gathers
    t1 = torch.einsum("rbij,rbjm->rbim", v1, Wc)
    G1 = torch.einsum("rin,rbim->rbnm", Wb, t1).reshape(-1, m, m)
    coarse = v1.new_zeros((na * na, m, m)).index_add_(0, ast.bins1, G1)
    if structure.heavy_rows.shape[0]:
        Wh = Wb[structure.heavy_rows.long()]
        t2 = torch.einsum("rbij,rbjm->rbim", v2, Wb[structure.bcols2.long()])
        G2 = torch.einsum("rin,rbim->rbnm", Wh, t2).reshape(-1, m, m)
        coarse.index_add_(0, ast.bins2, G2)
    Ac = coarse.reshape(na, na, m, m).permute(0, 2, 1, 3).reshape(na * m, na * m)
    Ac = 0.5 * (Ac + Ac.T)
    shift_scale = torch.clamp(torch.trace(Ac) / (na * m), min=1.0)
    eye = torch.eye(na * m, dtype=Ac.dtype, device=Ac.device)
    coarse_inv = spd_inverse(Ac + 1e-7 * shift_scale * eye)

    safe = torch.where(diag != 0, diag, torch.ones_like(diag))
    inv_agg = None
    if fine == "agg_block":
        if gs is None:
            gs = min(default_aggregate_size(structure), 128)
        inv_agg = aggregate_block_inverses(structure, values, gs, table=agg_table)
        blk_inv = None
    else:
        blk_inv = _fine_block_smoother(v1, fine)
    return AffineTwoLevel(
        inv_diag=1.0 / safe,
        coarse_inv=coarse_inv,
        W=ast.W.to(v1.dtype),
        blk_inv=blk_inv,
        inv_agg=inv_agg,
        gs=0 if gs is None else int(gs),
    )


def rbm_two_level_setup(basis, structure):
    """The rigid-body-mode coarse tables of a vector basis, built once and
    cached on the basis (``get_affine_two_level_structure``, with its
    ``ValueError`` on a scalar basis); returns ``setup(values, diag) ->
    AffineTwoLevel`` of assembled ``values`` (8x8 block-Jacobi smoother)."""
    ast = get_affine_two_level_structure(basis, structure, rbm=True)
    return lambda values, diag: affine_two_level_from_values(ast, structure, values, diag)


def auto_preconditioner_setup(basis, structure):
    """The host tables of ``auto_preconditioner``, built once per basis and
    layout and cached on the basis; returns ``setup(values, diag) -> M``
    of assembled ``values``."""
    if int(getattr(basis, "n_components", 1)) >= 2:
        return rbm_two_level_setup(basis, structure)
    g = default_aggregate_size(structure)
    gs = min(g, 128)
    cache = getattr(basis, "_agg_block_tables", None)
    if cache is None:
        cache = {}
        basis._agg_block_tables = cache
    key = (structure.nb, structure.bcols.shape[1], gs)
    table = cache.get(key)
    if table is None:
        table = torch.as_tensor(
            build_agg_block_table(structure, gs), device=structure.bcols.device
        )
        cache[key] = table
    return lambda values, diag: agg_block_two_level_from_values(
        structure, values, diag, g=g, gs=gs, table=table
    )


def auto_preconditioner(basis, structure, values, diag):
    """Size-appropriate aggregate preconditioner for the BSR operator.

    A scalar basis gets the aggregate-block two-level M (``g`` from
    ``default_aggregate_size``, ``gs = min(g, 128)``), its aggregate table
    built once per basis and layout and held on the device. A vector basis
    (``n_components >= 2``, elasticity) gets the rigid-body-mode coarse
    space with the 8x8 block-Jacobi smoother (``rbm_two_level_setup``).
    """
    return auto_preconditioner_setup(basis, structure)(values, diag)


# -- the ELL family ----------------------------------------------------------


class SmoothedTwoLevel(NamedTuple):
    """M^{-1} = D^{-1} + P A_c^{-1} P^T with a smoothed-aggregation P.

    P = (I - omega D^{-1} A) P0, P0 piecewise-constant over spatial
    aggregates. All applies are gather-only: restriction gathers r at P's
    fine rows per coarse column, the coarse solve is a dense matvec with the
    precomputed inverse, prolongation gathers z_c at each fine row's coarse
    columns.
    """

    inv_diag: torch.Tensor  # (n,)
    p_cols: torch.Tensor  # (n, KP) int64 coarse column ids per fine row
    p_vals: torch.Tensor  # (n, KP) weights (0 on padding)
    pt_rows: torch.Tensor  # (nc, DP) int64 fine row ids per coarse column (pad -> n)
    pt_vals: torch.Tensor  # (nc, DP) weights (0 on padding)
    coarse_inv: torch.Tensor  # (nc, nc)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        r_pad = torch.cat([r, r.new_zeros(1)])
        r_c = (self.pt_vals * r_pad[self.pt_rows]).sum(dim=-1)
        z_c = self.coarse_inv @ r_c
        z_fine = (self.p_vals * z_c[self.p_cols]).sum(dim=-1)
        return self.inv_diag * r + z_fine


class TwoLevelStructure(NamedTuple):
    """Value-independent tables of the smoothed two-level M, built on the
    host once per ELL layout and held on the device; the numeric setup
    (``two_level_from_values``) then runs on the device alone."""

    slot_pslot: torch.Tensor  # (n, K): P-slot of each ELL slot (KP = dropped)
    p_cols: torch.Tensor  # (n, KP) coarse (aggregate) column ids
    p_mask: torch.Tensor  # (n, KP) 1.0 where a real P entry lives
    is_self: torch.Tensor  # (n, KP) 1.0 where the entry is the own aggregate
    pt_rows: torch.Tensor  # (nc, DP) fine rows per coarse column (pad -> n)
    pt_gather: torch.Tensor  # (nc, DP) flat (i*KP+p) P-entry ids (pad -> n*KP)
    ac_bins: torch.Tensor  # (n*K,) coarse bin of each ELL slot
    ac_spill_bins: torch.Tensor  # (S,)
    nc: int
    kp: int


def build_two_level_structure(
    structure: ELLStructure, coords: np.ndarray, leaf: int = 32, kp: int = 4
) -> TwoLevelStructure:
    """Host-side once-per-basis construction of the two-level tables
    (byte-identical to the JAX package's), on the ELL structure's device."""
    device = structure.cols.device
    n = structure.n_inner
    K = structure.cols.shape[1]
    agg = spatial_aggregates(coords, leaf)
    nc = int(agg.max()) + 1

    cols = structure.cols.cpu().numpy().astype(np.int64)
    pad_mask = structure.pad_mask.cpu().numpy() > 0
    acols = agg[cols]  # (n, K) aggregate of each neighbor
    rows_agg = agg[np.arange(n)]

    # per-row distinct-aggregate enumeration: own aggregate first, then in
    # first-occurrence order, capped at kp
    SENTINEL = nc + 1
    acols_m = np.where(pad_mask, acols, SENTINEL)  # (n, K)
    ext = np.concatenate([rows_agg[:, None], acols_m], axis=1)  # (n, K+1)

    # first-occurrence flag per position: not equal to any earlier position
    eq = ext[:, :, None] == ext[:, None, :]  # (n, K+1, K+1)
    earlier = np.tril(np.ones((K + 1, K + 1), dtype=bool), k=-1)
    seen_before = (eq & earlier[None]).any(axis=2)
    is_first = (~seen_before) & (ext != SENTINEL)

    # p-index of each first occurrence (own aggregate at position 0 -> p=0)
    p_of_pos = np.cumsum(is_first, axis=1) - 1
    p_of_pos = np.where(is_first, p_of_pos, kp)

    # for every position, the p of its value = p at its first occurrence
    first_pos = np.argmax(eq & is_first[:, None, :], axis=2)  # (n, K+1)
    p_all = np.take_along_axis(p_of_pos, first_pos, axis=1)
    p_all = np.where(ext == SENTINEL, kp, np.minimum(p_all, kp))

    slot_pslot = np.where(p_all[:, 1:] < kp, p_all[:, 1:], kp)

    p_cols = np.zeros((n, kp), dtype=np.int64)
    p_mask = np.zeros((n, kp), dtype=np.float64)
    rows_idx = np.repeat(np.arange(n), K + 1).reshape(n, K + 1)
    sel = is_first & (p_of_pos < kp)
    p_cols[rows_idx[sel], p_of_pos[sel]] = ext[sel]
    p_mask[rows_idx[sel], p_of_pos[sel]] = 1.0
    is_self = np.zeros((n, kp), dtype=np.float64)
    is_self[:, 0] = 1.0  # own aggregate always occupies slot 0

    # restrict tables: invert the (i, p) -> coarse column map
    flat_cols = p_cols.reshape(-1)
    flat_live = np.nonzero(p_mask.reshape(-1) > 0)[0]
    pt_gather = invert_scatter_map(flat_cols[flat_live], nc, flat_live, pad=n * kp)
    pt_rows = np.where(pt_gather < n * kp, pt_gather // kp, n)

    rows = np.repeat(np.arange(n), K)
    ac_bins = rows_agg[rows].astype(np.int64) * nc + agg[cols.reshape(-1)]
    if structure.spill_rows.shape[0]:
        ac_spill_bins = (
            agg[structure.spill_rows.cpu().numpy()] * nc
            + agg[structure.spill_cols.cpu().numpy()]
        )
    else:
        ac_spill_bins = np.zeros((0,), dtype=np.int64)

    # bin ids reach nc^2 - 1 and would wrap int32 for nc > 46340
    wide = nc * nc > np.iinfo(np.int32).max
    f_t = structure.pad_mask.dtype

    def index(a, wide=False):
        a = np.asarray(a).astype(np.int64 if wide else np.int32)
        return torch.as_tensor(a, device=device)

    def real(a):
        return torch.as_tensor(a, dtype=f_t, device=device)

    return TwoLevelStructure(
        slot_pslot=index(slot_pslot),
        p_cols=index(p_cols),
        p_mask=real(p_mask),
        is_self=real(is_self),
        pt_rows=index(pt_rows),
        pt_gather=index(pt_gather),
        ac_bins=index(ac_bins, wide),
        ac_spill_bins=index(ac_spill_bins, wide),
        nc=nc,
        kp=kp,
    )


def _safe_inverse(diag: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(diag != 0, diag, torch.ones_like(diag))


def _symmetric_inverse(coarse: torch.Tensor, shift_factor: float) -> torch.Tensor:
    """Symmetrise against roundoff, shift by ``shift_factor * trace / n``
    (pure-Neumann aggregates could be singular) and invert."""
    n = coarse.shape[0]
    coarse = 0.5 * (coarse + coarse.T)
    shift = shift_factor * torch.trace(coarse) / n
    eye = torch.eye(n, dtype=coarse.dtype, device=coarse.device)
    return spd_inverse(coarse + shift * eye)


def two_level_from_values(
    tl: TwoLevelStructure,
    structure: ELLStructure,
    values,
    diag,
    omega: float = 0.67,
) -> SmoothedTwoLevel:
    """Per-assembly numeric setup of the smoothed two-level M, on the device.

    P = (I - omega D^{-1} A) P0 evaluated per row from the ELL values (spill
    entries approximated away — truncation-level error only); coarse matrix
    A_c = P0^T A P0 via one scatter into nc^2 bins, symmetrised, shifted by
    1e-7 trace/nc and inverted.
    """
    ell, spill = values
    kp, nc = tl.kp, tl.nc
    inv_diag = _safe_inverse(diag)

    masked = ell * structure.pad_mask
    zero = torch.zeros_like(masked)
    # contrib[i, p] = sum of row i's A-entries landing in P-slot p
    contrib = torch.stack(
        [torch.where(tl.slot_pslot == p, masked, zero).sum(dim=-1) for p in range(kp)],
        dim=-1,
    )  # (n, kp)
    p_vals = (tl.is_self - omega * inv_diag[:, None] * contrib) * tl.p_mask

    # restrict values: gather of the prolong values (static inverse map)
    pt_vals = torch.cat([p_vals.reshape(-1), p_vals.new_zeros(1)])[tl.pt_gather]

    coarse = masked.new_zeros(nc * nc).index_add(0, tl.ac_bins, masked.reshape(-1))
    if structure.spill_rows.shape[0]:
        coarse = coarse.index_add(0, tl.ac_spill_bins, spill)
    coarse_inv = _symmetric_inverse(coarse.reshape(nc, nc), 1e-7)

    # the apply's gather indices as int64, widened once here rather than
    # by PyTorch's gather on every apply
    return SmoothedTwoLevel(
        inv_diag=inv_diag,
        p_cols=tl.p_cols.long(),
        p_vals=p_vals,
        pt_rows=tl.pt_rows.long(),
        pt_vals=pt_vals,
        coarse_inv=coarse_inv,
    )


def build_two_level(
    structure: ELLStructure, values, diag, block: int = 128
) -> TwoLevelPreconditioner:
    """The two-level M over contiguous index blocks of an assembled ELL
    operator: ``A_c[a, b]`` sums the entries with row in block a and column
    in block b (one scatter-add over the ELL slots), shifted by
    1e-8 trace/nb."""
    n = structure.n_inner
    K = structure.cols.shape[1]
    nb = -(-n // block)
    n_pad = nb * block

    ell, spill = values
    cols = structure.cols.long()
    row_agg = (torch.arange(n, device=ell.device) // block)[:, None].expand(n, K)
    bins = (row_agg * nb + cols // block).reshape(-1)
    vals = (ell * structure.pad_mask).reshape(-1)
    coarse = vals.new_zeros(nb * nb).index_add(0, bins, vals)
    if structure.spill_rows.shape[0]:
        spill_bins = (structure.spill_rows.long() // block) * nb + (
            structure.spill_cols.long() // block
        )
        coarse = coarse.index_add(0, spill_bins, spill)
    coarse_inv = _symmetric_inverse(coarse.reshape(nb, nb), 1e-8)
    return TwoLevelPreconditioner(
        inv_diag=_safe_inverse(diag),
        coarse_inv=coarse_inv,
        block=block,
        n=n,
        n_pad=n_pad,
    )
