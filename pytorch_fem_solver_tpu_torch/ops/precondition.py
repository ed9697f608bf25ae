"""Aggregate two- and three-level preconditioners for the BSR system.

Counterpart of ``pytorch_fem_solver_tpu/ops/precondition.py``:

    M^{-1} r = D_g^{-1} r + P0 A_c^{-1} P0^T r,      A_c = P0^T A P0

with aggregates chosen as contiguous, equal-size index groups of the BSR
layout's spatial order, so restriction and prolongation are reshapes, the
coarse solve is one dense matvec against a precomputed inverse, and D_g is
the block diagonal over the same groups. The additive combination of SPD
terms is SPD, so CG theory applies unchanged.

Beside the aggregate-block M: the 8x8 block-Jacobi two-level M
(``block_two_level_from_values``), the additive three-level hierarchy with
a sparse intermediate level (``ThreeLevelStructure`` host tables,
``three_level_from_values``), the symmetrized multiplicative V(1,1) cycles
over the two- and three-level hierarchies (``mult_two_level_from_values``,
``mult_three_level_from_values``; the smoother damped by
``_smoother_scale``) and the matrix-free smoothed-aggregation two-level M
(``smoothed_two_level_matrix_free``), whose P applies are two more SpMVs.

The affine / rigid-body-mode family follows (``AffineTwoLevelStructure``
host tables with W from NumPy's float64 QR, ``affine_two_level_from_values``
per assembly): the coarse space of vector bases, which
``auto_preconditioner`` picks for ``n_components >= 2``. Then the ELL
family: the smoothed two-level preconditioner of the hybrid-ELL operator
(``TwoLevelStructure`` host tables built once, ``two_level_from_values``
per assembly, or the scipy setup ``build_smoothed_two_level`` with the
smoothed Galerkin coarse matrix: gather-only restriction and prolongation
and a dense coarse inverse) and the plain block two-level
``build_two_level``.

Under a profiler session the numeric set-ups of the block and affine
families record the spans ``fem.precond_setup.galerkin`` (the coarse
matrix, symmetrised), ``fem.precond_setup.coarse_inverse`` (its shift and
``spd_inverse``) and ``fem.precond_setup.smoother`` (the fine smoother's
block or aggregate-block inverses), and add the coarse size to the
counter ``coarse_rows`` (``utils.profiling``).

``operand_dtype`` (e.g. ``torch.bfloat16``) stores the dense apply
operands of the BSR family (block and aggregate-block inverses, coarse and
bottom-level inverses) in a reduced dtype; each apply then rounds its
vector to that dtype and sums the exact products in the vector's dtype
(``_mixed_matvec``). The W transfers of the affine family stay in the
values' dtype.
"""

from __future__ import annotations

import ctypes
import math
import sys
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..utils.profiling import count, read, span
from . import cuda_build
from .bsr import bsr_matvec
from .sparse import ELLStructure, invert_scatter_map


def spd_inverse(a: torch.Tensor) -> torch.Tensor:
    """Explicit inverse of a (shifted) SPD matrix via Cholesky.

    Non-SPD inputs fall back to the LU-based inverse, as in the JAX package
    (there a non-finite Cholesky factor selects the fallback; here the
    ``info`` flag of ``cholesky_ex`` does, since ``cholesky`` would raise).
    The test makes two blocking host reads (``utils.profiling.read``).
    """
    n = a.shape[-1]
    chol, info = torch.linalg.cholesky_ex(a)
    if read(info) != 0 or not read(torch.isfinite(chol).all()):
        return torch.linalg.inv(a)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    l_inv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return l_inv.T @ l_inv


def _prolong(z_c: torch.Tensor, g: int, n: int) -> torch.Tensor:
    """Piecewise-constant prolongation: repeat each coarse value g times."""
    return z_c[..., :, None].expand(*z_c.shape, g).reshape(*z_c.shape[:-1], n)


def _mixed_matvec(eq: str, mat: torch.Tensor, vec: torch.Tensor, out_dtype) -> torch.Tensor:
    """The apply's matvec on operands that may be stored reduced (bf16).

    Equal dtypes take the plain product (``@`` for ``"ij,j->i"``, else
    ``einsum``). Otherwise ``vec`` is rounded to ``mat``'s dtype and the
    products are summed in ``out_dtype``, as the JAX package's
    ``einsum(..., preferred_element_type=out_dtype)`` does: the product of
    two bf16 numbers is exact in float32, so both operands are widened
    before an ``out_dtype`` einsum (a bf16 einsum would round its output
    to bf16). The widened copy of ``mat`` is made per call.
    """
    if mat.dtype == vec.dtype:
        return mat @ vec if eq == "ij,j->i" else torch.einsum(eq, mat, vec)
    return torch.einsum(eq, mat.to(out_dtype), vec.to(mat.dtype).to(out_dtype))


def _coarse_apply(coarse_inv: torch.Tensor, g: int, r: torch.Tensor) -> torch.Tensor:
    """P0 A_c^{-1} P0^T r over contiguous aggregates of ``g``: the
    restriction and the prolongation are reshapes."""
    r_c = r.reshape(-1, g).sum(dim=-1)
    z_c = _mixed_matvec("ij,j->i", coarse_inv, r_c, r.dtype)
    return _prolong(z_c, g, r.shape[0])


def _apply_fine(blk_inv, inv_diag, r):
    """Fine smoother application: batched block-Jacobi or point Jacobi."""
    if blk_inv is None:
        return inv_diag * r
    k = blk_inv.shape[-1]
    return _mixed_matvec("rij,rj->ri", blk_inv, r.reshape(-1, k), r.dtype).reshape(-1)


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
        return _coarse_apply(self.coarse_inv, self.g, r)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return _apply_fine(self.blk_inv, self.inv_diag, r) + self.coarse_apply(r)


#: one CTA's shared memory on an H100, which holds K7's (n, n) block and the
#: 4 n words of its pivot copies above n = 128 (``csrc/small_inv.cu``)
SMALL_INV_SHARED_BYTES = 227 * 1024
_SMALL_INV_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_void_p,
]


def small_inv_max_n(dtype: torch.dtype) -> int:
    """The largest n K7 takes in ``dtype``: 239 in float32, 168 in float64
    (n^2 + 4 n words in ``SMALL_INV_SHARED_BYTES``)."""
    words = SMALL_INV_SHARED_BYTES // torch.empty((), dtype=dtype).element_size()
    return math.isqrt(words + 4) - 2


def batched_small_inv(a: torch.Tensor) -> torch.Tensor:
    """Batched inverse of small SPD matrices via Gauss-Jordan.

    No pivoting — the inputs are SPD diagonal blocks of an assembled
    stiffness operator, where diagonal pivots are the stable choice. The
    same elimination as the JAX package, so float64 results agree to
    roundoff.

    CPU tensors take ``_batched_small_inv_plain``. CUDA tensors launch K7
    (``csrc/small_inv.cu``: the same elimination kept in place, one launch
    for the batch) or raise: for a dtype other than float32 / float64 and
    for n > ``small_inv_max_n(dtype)``. The result is contiguous.
    """
    if a.device.type == "cpu":
        return _batched_small_inv_plain(a)
    n = a.shape[-1]
    if a.dim() < 2 or a.shape[-2] != n:
        raise ValueError(f"batched_small_inv: (..., n, n) blocks expected, got {tuple(a.shape)}")
    if a.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"batched_small_inv: K7 takes float32 or float64, got {a.dtype}")
    max_n = small_inv_max_n(a.dtype)
    if n > max_n:
        raise ValueError(
            f"batched_small_inv: n = {n} > {max_n}, the largest {a.dtype} block "
            f"one CTA of K7 holds"
        )
    a = a.contiguous()
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    batch = a.numel() // (n * n) if n else 0
    if batch == 0:
        return out
    cuda_build.check(a, "a", a.shape, a.dtype)
    fn = cuda_build.function("small_inv", "small_inv", a.dtype, _SMALL_INV_ARGTYPES)
    err = fn(
        a.data_ptr(), out.data_ptr(), n, batch,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "small_inv")
    cuda_build.launch_counts["small_inv"] += 1
    return out


def _batched_small_inv_plain(a: torch.Tensor) -> torch.Tensor:
    """The plain version of K7: the JAX package's unrolled Gauss-Jordan
    over the augmented (..., n, 2n) matrix [A | I], one pivot at a time."""
    n = a.shape[-1]
    eye = torch.eye(n, dtype=a.dtype, device=a.device).expand(a.shape)
    aug = torch.cat([a, eye], dim=-1)  # (..., n, 2n)
    for k in range(n):
        pivot_row = aug[..., k, :] / aug[..., k, k : k + 1]
        aug = aug - aug[..., :, k : k + 1] * pivot_row[..., None, :]
        aug[..., k, :] = pivot_row
    return aug[..., n:].contiguous()


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
    operand_dtype=None,
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
      operand_dtype: storage dtype of the block and coarse inverses (e.g.
        ``torch.bfloat16``; see ``_mixed_matvec``); None keeps the values'.
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
    with span("fem.precond_setup.galerkin", v1.device):
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
    count("coarse_rows", nc)
    with span("fem.precond_setup.coarse_inverse", v1.device):
        # aggregates made purely of padding rows are all-zero: the shift keeps
        # the inverse finite without affecting preconditioning quality
        shift_scale = torch.clamp(torch.trace(coarse) / nc, min=1.0)
        coarse_inv = spd_inverse(
            coarse + 1e-7 * shift_scale * torch.eye(nc, dtype=coarse.dtype, device=coarse.device)
        )

    safe = torch.where(diag != 0, diag, torch.ones_like(diag))
    blk_inv = _fine_block_smoother(v1, fine, operand_dtype)
    if operand_dtype is not None:
        coarse_inv = coarse_inv.to(operand_dtype)
    return BlockTwoLevel(inv_diag=1.0 / safe, coarse_inv=coarse_inv, g=g, blk_inv=blk_inv)


def _fine_block_smoother(v1, fine: str = "block_jacobi", operand_dtype=None):
    """Diagonal-block inverses of the fine smoother (None for point
    Jacobi), in ``operand_dtype`` when given. The diagonal block of a
    block-row always lives at tier-1 slot b=0; padded rows' all-zero
    blocks are pinned to identity."""
    if fine == "jacobi":
        return None
    if fine != "block_jacobi":
        raise ValueError(f"unknown fine smoother: {fine!r}")
    with span("fem.precond_setup.smoother", v1.device):
        blk_inv = batched_small_inv(_pin_zero_diagonal(v1[:, 0]))
        return blk_inv if operand_dtype is None else blk_inv.to(operand_dtype)


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
        return _coarse_apply(self.coarse_inv, self.g, r)

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        fine = _mixed_matvec(
            "rij,rj->ri", self.inv_agg, r.reshape(-1, self.gs), r.dtype
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
    operand_dtype=None,
):
    """Numeric setup of the aggregate-block two-level M.

    Same Galerkin coarse level as ``block_two_level_from_values``; the fine
    smoother inverts the (gs, gs) aggregate diagonal blocks. ``gs`` defaults
    to ``min(g, 128)``. ``table`` may be precomputed: the device tensor of
    ``build_agg_block_table`` (value-independent). ``operand_dtype`` stores
    both inverses reduced.
    """
    base = block_two_level_from_values(
        structure, values, diag, g=g, fine="jacobi", operand_dtype=operand_dtype
    )
    g = base.g
    gs = min(g, 128) if gs is None else gs
    inv_agg = aggregate_block_inverses(
        structure, values, gs, table=table, operand_dtype=operand_dtype
    )
    # contiguous, as the fused tail's kernels read them
    return AggBlockTwoLevel(
        inv_agg=inv_agg,
        coarse_inv=base.coarse_inv.contiguous(),
        g=g,
        gs=gs,
    )


def aggregate_block_inverses(structure, values, gs: int, table=None, operand_dtype=None):
    """(ns, gs, gs) inverses of the aggregate diagonal blocks, in
    ``operand_dtype`` when given."""
    if gs % structure.block or structure.n_pad % gs:
        raise ValueError(
            f"smoother block size {gs} must be a multiple of "
            f"block {structure.block} and divide n_pad {structure.n_pad}"
        )
    k = structure.block
    v1, v2 = values
    if table is None:
        table = torch.as_tensor(build_agg_block_table(structure, gs), device=v1.device)
    with span("fem.precond_setup.smoother", v1.device):
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
        inv_agg = batched_small_inv(_pin_zero_diagonal(D))
        return inv_agg if operand_dtype is None else inv_agg.to(operand_dtype)


# -- the three-level family -----------------------------------------------------


class ThreeLevelStructure(NamedTuple):
    """Host-built tables of the additive three-level preconditioner, on the
    structure's device (int32, as the JAX package keeps them).

    The intermediate coarse matrix A_c = P1^T A P1 (g1-aggregates) is kept
    sparse: its unique entries are ``n_slots`` slots, filled by one scatter
    of the per-block sums, from which the g2 x g2 diagonal blocks are
    gathered directly and the dense bottom level summed.
    """

    slot_of_block: torch.Tensor  # (nb*B,) coarse slot per tier-1 block
    slot_of_block2: torch.Tensor  # (nh*B2,) coarse slot per tier-2 block
    diag_take: torch.Tensor  # (ncb, g2, g2) coarse slot per mid-diag entry
    acc_bins: torch.Tensor  # (S,) bottom-level bin per coarse entry
    n_slots: int
    nc1: int
    nc1p: int
    ncb: int
    g1: int
    g2: int


class ThreeLevel(NamedTuple):
    """M^{-1} = B^{-1} + P1 (B_c^{-1} + P2 A_cc^{-1} P2^T) P1^T.

    Additive three-level hierarchy over contiguous aggregates: 8x8
    block-Jacobi at the fine level, g2 x g2 block-Jacobi on the sparse A_c
    at the intermediate level, a dense inverse only at the bottom level
    (nc1/g2 unknowns). All transfers are reshapes and broadcasts.
    """

    blk_inv: torch.Tensor  # (nb, k, k) fine diagonal-block inverses
    mblk_inv: torch.Tensor  # (ncb, g2, g2) intermediate block inverses
    acc_inv: torch.Tensor  # (ncb, ncb) bottom-level dense inverse
    g1: int
    g2: int
    nc1: int
    nc1p: int

    def coarse_apply(self, r: torch.Tensor) -> torch.Tensor:
        """P1 (B_c^{-1} + P2 A_cc^{-1} P2^T) P1^T r — transfers are reshapes."""
        r_c = torch.nn.functional.pad(
            r.reshape(-1, self.g1).sum(dim=-1), (0, self.nc1p - self.nc1)
        )
        mid = _mixed_matvec(
            "rij,rj->ri", self.mblk_inv, r_c.reshape(-1, self.g2), r.dtype
        ).reshape(-1)
        z_cc = _mixed_matvec(
            "ij,j->i", self.acc_inv, r_c.reshape(-1, self.g2).sum(dim=-1), r.dtype
        )
        z_c = (mid + _prolong(z_cc, self.g2, self.nc1p))[: self.nc1]
        return _prolong(z_c, self.g1, r.shape[0])

    def __call__(self, r: torch.Tensor) -> torch.Tensor:
        return _apply_fine(self.blk_inv, None, r) + self.coarse_apply(r)


def build_three_level_structure(structure, g1: int = 32, g2: int = 32) -> ThreeLevelStructure:
    """Host-side once-per-layout tables of the sparse-coarse three-level M
    (NumPy, byte-identical to the JAX package's), moved to the structure's
    device."""
    block = structure.block
    if g1 % block or structure.n_pad % g1:
        raise ValueError(
            f"g1={g1} must be a multiple of block {block} and divide "
            f"n_pad {structure.n_pad}"
        )
    bcols = structure.bcols.cpu().numpy().astype(np.int64)
    nb, B = bcols.shape
    bpa = g1 // block
    nc1 = structure.n_pad // g1

    rows_c = np.repeat(np.arange(nb) // bpa, B)
    pairs1 = rows_c * nc1 + (bcols // bpa).reshape(-1)
    heavy = structure.heavy_rows.cpu().numpy().astype(np.int64)
    bcols2 = structure.bcols2.cpu().numpy().astype(np.int64)
    if heavy.size:
        rows2 = np.repeat(heavy // bpa, bcols2.shape[1])
        pairs2 = rows2 * nc1 + (bcols2 // bpa).reshape(-1)
    else:
        pairs2 = np.zeros((0,), dtype=np.int64)

    upairs, inv = np.unique(np.concatenate([pairs1, pairs2]), return_inverse=True)
    inv = inv.reshape(-1)
    S = int(upairs.size)
    ur = upairs // nc1
    uc = upairs % nc1

    nc1p = -(-nc1 // g2) * g2
    ncb = nc1p // g2
    diag_take = np.full((ncb, g2, g2), S, dtype=np.int64)
    on_diag = (ur // g2) == (uc // g2)
    diag_take[ur[on_diag] // g2, ur[on_diag] % g2, uc[on_diag] % g2] = np.nonzero(on_diag)[0]
    acc_bins = (ur // g2) * ncb + uc // g2

    device = structure.bcols.device

    def index(a):
        return torch.as_tensor(
            np.asarray(a).astype(np.int32), dtype=config.index_dtype(), device=device
        )

    return ThreeLevelStructure(
        slot_of_block=index(inv[: pairs1.size]),
        slot_of_block2=index(inv[pairs1.size:]),
        diag_take=index(diag_take),
        acc_bins=index(acc_bins),
        n_slots=S,
        nc1=int(nc1),
        nc1p=int(nc1p),
        ncb=int(ncb),
        g1=int(g1),
        g2=int(g2),
    )


def get_three_level_structure(basis, structure, g1: int = 32, g2: int = 32) -> ThreeLevelStructure:
    """Cached-per-basis three-level tables (host-built once per BSR layout),
    keyed as the JAX package keys them."""
    cache = getattr(basis, "_three_level_structures", None)
    if cache is None:
        cache = {}
        basis._three_level_structures = cache
    key = (structure.nb, structure.bcols.shape[1], structure.heavy_rows.shape[0], g1, g2)
    tl = cache.get(key)
    if tl is None:
        tl = build_three_level_structure(structure, g1=g1, g2=g2)
        cache[key] = tl
    return tl


def three_level_from_values(
    tl: ThreeLevelStructure, structure, values, diag, operand_dtype=None
) -> ThreeLevel:
    """Numeric setup of the sparse-coarse three-level M, on the device.

    The per-block sums scatter into A_c's ``n_slots`` unique entries
    (``index_add_``; slot ``n_slots`` is the padding slot, pinned to 0, so
    gathering it yields 0); the g2 x g2 diagonal blocks are gathered from
    them (zero diagonals pinned to one) and inverted by Gauss-Jordan; the
    bottom level sums them into ``ncb * ncb`` bins, is symmetrised, shifted
    by 1e-7 max(trace / ncb, 1) and inverted by Cholesky.
    ``operand_dtype`` stores the three dense apply operands reduced.
    """
    v1, v2 = values
    coarse = v1.new_zeros(tl.n_slots + 1)
    coarse.index_add_(0, tl.slot_of_block.long(), v1.sum(dim=(-1, -2)).reshape(-1))
    if structure.heavy_rows.shape[0]:
        coarse.index_add_(0, tl.slot_of_block2.long(), v2.sum(dim=(-1, -2)).reshape(-1))
    coarse[tl.n_slots] = 0.0

    mblocks = coarse[tl.diag_take.long()]  # (ncb, g2, g2)
    mblk_inv = batched_small_inv(_pin_zero_diagonal(mblocks))

    acc = coarse.new_zeros(tl.ncb * tl.ncb).index_add_(
        0, tl.acc_bins.long(), coarse[: tl.n_slots]
    ).reshape(tl.ncb, tl.ncb)
    acc = 0.5 * (acc + acc.T)
    shift = 1e-7 * torch.clamp(torch.trace(acc) / tl.ncb, min=1.0)
    acc_inv = spd_inverse(acc + shift * torch.eye(tl.ncb, dtype=acc.dtype, device=acc.device))

    blk_inv = _fine_block_smoother(v1, "block_jacobi", operand_dtype)
    if operand_dtype is not None:
        mblk_inv = mblk_inv.to(operand_dtype)
        acc_inv = acc_inv.to(operand_dtype)
    return ThreeLevel(
        blk_inv=blk_inv,
        mblk_inv=mblk_inv,
        acc_inv=acc_inv,
        g1=tl.g1,
        g2=tl.g2,
        nc1=tl.nc1,
        nc1p=tl.nc1p,
    )


# -- the multiplicative cycles and the matrix-free smoothed M ------------------


def _smoother_scale(smooth, matvec, n: int, dtype, iters: int = 12, device=None):
    """1/rho(S A) from ``iters`` power-iteration steps: the smoother damping
    that keeps the symmetrized multiplicative cycle SPD.

    S A is similar to the SPD S^1/2 A S^1/2, so its top eigenvalue is real;
    the alternating-sign start overlaps the high-frequency end where the
    top modes live, and the 5% margin covers power iteration's approach
    from below. A Python loop of ``iters`` steps on the device: nothing is
    read back to the host. Returns a 0-dim tensor.
    """
    v = torch.where(torch.arange(n, device=device) % 2 == 0, 1.0, -1.0).to(dtype)
    v = v / torch.sqrt(torch.tensor(float(n), dtype=dtype, device=device))
    lam = torch.ones((), dtype=dtype, device=device)
    for _ in range(iters):
        w = smooth(matvec(v))
        lam = torch.sqrt(torch.sum(w * w))
        v = w / torch.clamp(lam, min=1e-30)
    return 1.0 / (1.05 * torch.clamp(lam, min=1e-30))


def _v11_cycle(blk_inv, coarse_apply, matvec, omega, structure, values):
    """The symmetrized multiplicative V(1,1) cycle of the 8x8 block-Jacobi
    smoother ``blk_inv`` around ``coarse_apply``, as a closure:

        z = S r;  z += C (r - A z);  z += S (r - A z)

    with S = scale * blockdiag(A)^{-1}, the scale ``_smoother_scale``'s for
    ``omega="auto"``, else ``omega``; ``matvec`` is the A of the two inner
    products and of the estimate."""
    v1 = values[0]

    def smooth0(r):
        return _apply_fine(blk_inv, None, r)

    if omega == "auto":
        scale = _smoother_scale(smooth0, matvec, structure.n_pad, v1.dtype, device=v1.device)
    else:
        scale = torch.tensor(omega, dtype=v1.dtype, device=v1.device)

    def smooth(r):
        return scale.to(r.dtype) * smooth0(r)

    def apply(r):
        z = smooth(r)
        z = z + coarse_apply(r - matvec(z))
        z = z + smooth(r - matvec(z))
        return z

    return apply


def mult_two_level_from_values(
    structure,
    values,
    diag,
    g: int | None = None,
    omega="auto",
    operand_dtype=None,
    inner_dtype=None,
):
    """Symmetrized multiplicative (V(1,1)) block two-level preconditioner.

    z = S r;  z += P0 A_c^{-1} P0^T (r - A z);  z += S (r - A z)

    with S = omega * blockdiag(A)^{-1} (8x8 block-Jacobi) and the coarse
    space of ``block_two_level_from_values``: two SpMVs (K2) per apply.
    ``omega="auto"`` scales the smoother by 1/rho(S A) from 12
    power-iteration SpMVs at setup (``_smoother_scale``); a float skips
    the estimate. ``inner_dtype`` (e.g. ``torch.bfloat16``) runs the two
    inner SpMVs and the estimate against a copy of the values in that
    dtype (K2's bf16-values instantiation on the card); ``operand_dtype``
    reduces the dense apply operands. Returns a closure, as the JAX
    package does.
    """
    base = block_two_level_from_values(structure, values, diag, g=g, operand_dtype=operand_dtype)
    inner_values = values
    if inner_dtype is not None:
        inner_values = tuple(v.to(inner_dtype) for v in values)
    return _v11_cycle(
        base.blk_inv, base.coarse_apply, lambda v: bsr_matvec(structure, inner_values, v),
        omega, structure, values,
    )


def mult_three_level_from_values(
    tl: ThreeLevelStructure,
    structure,
    values,
    diag,
    omega="auto",
    operand_dtype=None,
):
    """Symmetrized multiplicative V(1,1) cycle over the three-level
    hierarchy: the sandwich of ``mult_two_level_from_values`` with the
    coarse correction of ``three_level_from_values``. Two SpMVs (K2) per
    apply, 12 more at setup for ``omega="auto"``. Returns a closure."""
    base = three_level_from_values(tl, structure, values, diag, operand_dtype=operand_dtype)
    return _v11_cycle(
        base.blk_inv, base.coarse_apply, lambda v: bsr_matvec(structure, values, v),
        omega, structure, values,
    )


def smoothed_two_level_matrix_free(
    structure, values, diag, g: int | None = None, omega: float = 0.67
):
    """Smoothed-aggregation two-level M^{-1} with matrix-free P applies.

    M^{-1} = D^{-1} + P A_c^{-1} P^T with P = (I - omega D^{-1} A) P0, P
    never stored: the restriction is a BSR SpMV and a reshape-sum, the
    prolongation a broadcast and a BSR SpMV, so two SpMVs (K2) per apply.
    The coarse matrix is the tentative Galerkin A_c = P0^T A P0 of
    ``block_two_level_from_values`` (point-Jacobi fine part), not the
    smoothed P^T A P of ``build_smoothed_two_level``. Returns a closure.
    """
    if g is None:
        g = default_aggregate_size(structure)
    base = block_two_level_from_values(structure, values, diag, g=g, fine="jacobi")
    inv_diag, coarse_inv = base.inv_diag, base.coarse_inv
    n_pad = structure.n_pad

    def apply(r):
        # P^T r = P0^T (I - omega A D^{-1}) r
        rs = r - omega * bsr_matvec(structure, values, inv_diag * r)
        z_c = coarse_inv @ rs.reshape(-1, g).sum(dim=-1)
        # P z_c = (I - omega D^{-1} A) (P0 z_c)
        z0 = _prolong(z_c, g, n_pad)
        z = z0 - omega * inv_diag * bsr_matvec(structure, values, z0)
        return inv_diag * r + z

    return apply


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
        z_c = _mixed_matvec("ij,j->i", self.coarse_inv, r_c, r.dtype)
        z = torch.einsum("agm,am->ag", self.W, z_c.reshape(na, m)).reshape(-1)
        if self.inv_agg is not None:
            fine = _mixed_matvec(
                "rij,rj->ri", self.inv_agg, r.reshape(-1, self.gs), r.dtype
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
    operand_dtype=None,
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
    the device table of ``build_agg_block_table``. ``operand_dtype`` stores
    the coarse inverse and the smoother's inverses reduced; W stays in the
    values' dtype.
    """
    v1, v2 = values
    na, m = ast.na, ast.m
    Wb = ast.Wb.to(v1.dtype)

    with span("fem.precond_setup.galerkin", v1.device):
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
    count("coarse_rows", na * m)
    with span("fem.precond_setup.coarse_inverse", v1.device):
        shift_scale = torch.clamp(torch.trace(Ac) / (na * m), min=1.0)
        eye = torch.eye(na * m, dtype=Ac.dtype, device=Ac.device)
        coarse_inv = spd_inverse(Ac + 1e-7 * shift_scale * eye)

    safe = torch.where(diag != 0, diag, torch.ones_like(diag))
    inv_agg = None
    if fine == "agg_block":
        if gs is None:
            gs = min(default_aggregate_size(structure), 128)
        inv_agg = aggregate_block_inverses(
            structure, values, gs, table=agg_table, operand_dtype=operand_dtype
        )
        blk_inv = None
    else:
        blk_inv = _fine_block_smoother(v1, fine, operand_dtype)
    if operand_dtype is not None:
        coarse_inv = coarse_inv.to(operand_dtype)
    return AffineTwoLevel(
        inv_diag=1.0 / safe,
        coarse_inv=coarse_inv,
        W=ast.W.to(v1.dtype),
        blk_inv=blk_inv,
        inv_agg=inv_agg,
        gs=0 if gs is None else int(gs),
    )


def rbm_two_level_setup(basis, structure, operand_dtype=None):
    """The rigid-body-mode coarse tables of a vector basis, built once and
    cached on the basis (``get_affine_two_level_structure``, with its
    ``ValueError`` on a scalar basis); returns ``setup(values, diag) ->
    AffineTwoLevel`` of assembled ``values`` (8x8 block-Jacobi smoother)."""
    ast = get_affine_two_level_structure(basis, structure, rbm=True)
    return lambda values, diag: affine_two_level_from_values(
        ast, structure, values, diag, operand_dtype=operand_dtype
    )


def auto_preconditioner_setup(basis, structure, operand_dtype=None):
    """The host tables of ``auto_preconditioner``, built once per basis and
    layout and cached on the basis; returns ``setup(values, diag) -> M``
    of assembled ``values``."""
    if int(getattr(basis, "n_components", 1)) >= 2:
        return rbm_two_level_setup(basis, structure, operand_dtype)
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
        structure, values, diag, g=g, gs=gs, table=table, operand_dtype=operand_dtype
    )


def auto_preconditioner(basis, structure, values, diag, operand_dtype=None):
    """Size-appropriate aggregate preconditioner for the BSR operator.

    A scalar basis gets the aggregate-block two-level M (``g`` from
    ``default_aggregate_size``, ``gs = min(g, 128)``), its aggregate table
    built once per basis and layout and held on the device. A vector basis
    (``n_components >= 2``, elasticity) gets the rigid-body-mode coarse
    space with the 8x8 block-Jacobi smoother (``rbm_two_level_setup``).
    ``operand_dtype`` stores the dense apply operands reduced.
    """
    return auto_preconditioner_setup(basis, structure, operand_dtype)(values, diag)


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


def build_smoothed_two_level(
    structure: ELLStructure,
    values,
    coords: np.ndarray,
    leaf: int = 32,
    omega: float = 0.67,
    max_row_nnz: int = 4,
) -> SmoothedTwoLevel:
    """Host setup (scipy, float64) of the smoothed two-level M of an
    assembled ELL operator, its tables moved to the values' device.

    P = (I - omega D^{-1} A) P0 over ``spatial_aggregates(coords, leaf)``,
    each row truncated to its ``max_row_nnz`` largest-|weight| entries (the
    same argsort as the JAX package, so the same entries are kept); the
    smoothed Galerkin A_c = P^T A P, symmetrised, shifted by 1e-8 trace/nc
    and inverted by NumPy. ``p_cols``/``pt_rows`` (restriction rows padded
    with n) are the JAX package's tables element for element, as int64.

    Args:
      structure/values: assembled hybrid-ELL operator (reduced system).
      coords: (n_inner, d) coordinates of the reduced DOFs (for clustering).
    """
    import scipy.sparse as sp

    n = structure.n_inner
    ell, spill = values
    ell_np = ell.detach().cpu().numpy() * structure.pad_mask.cpu().numpy()
    cols_np = structure.cols.cpu().numpy()
    rows_np = np.repeat(np.arange(n), cols_np.shape[1])
    A = sp.csr_matrix((ell_np.reshape(-1), (rows_np, cols_np.reshape(-1))), shape=(n, n))
    if structure.spill_rows.shape[0]:
        A = A + sp.csr_matrix(
            (
                spill.detach().cpu().numpy(),
                (structure.spill_rows.cpu().numpy(), structure.spill_cols.cpu().numpy()),
            ),
            shape=(n, n),
        )

    D = np.where(A.diagonal() != 0, A.diagonal(), 1.0)
    agg = spatial_aggregates(coords, leaf)
    nc = int(agg.max()) + 1
    P0 = sp.csr_matrix((np.ones(n), (np.arange(n), agg)), shape=(n, nc))
    P = ((sp.identity(n, format="csr") - omega * sp.diags(1.0 / D) @ A) @ P0).tocsr()

    # truncate each row of P to its largest-|weight| entries
    if max_row_nnz is not None:
        indptr, indices, data = P.indptr, P.indices, P.data
        keep_mask = np.ones(P.nnz, dtype=bool)
        counts = np.diff(indptr)
        for row in np.nonzero(counts > max_row_nnz)[0]:
            s, e = indptr[row], indptr[row + 1]
            drop = np.argsort(np.abs(data[s:e]))[: (e - s) - max_row_nnz]
            keep_mask[s + drop] = False
        row_of_nnz = np.repeat(np.arange(n), counts)
        new_counts = np.bincount(row_of_nnz[keep_mask], minlength=n)
        P = sp.csr_matrix(
            (data[keep_mask], indices[keep_mask], np.concatenate([[0], np.cumsum(new_counts)])),
            shape=(n, nc),
        )

    Ac = (P.T @ A @ P).toarray()
    Ac = 0.5 * (Ac + Ac.T)
    shift = 1e-8 * np.trace(Ac) / nc
    Ac_inv = np.linalg.inv(Ac + shift * np.eye(nc))

    # prolong table: per fine row, its coarse columns + weights
    coo = P.tocoo()
    kp = int(np.bincount(coo.row, minlength=n).max())
    p_cols = np.zeros((n, kp), dtype=np.int64)
    p_vals = np.zeros((n, kp), dtype=np.float64)
    order = np.argsort(coo.row, kind="stable")
    starts = np.concatenate([[0], np.cumsum(np.bincount(coo.row, minlength=n))])
    pos = np.arange(coo.nnz) - starts[coo.row[order]]
    p_cols[coo.row[order], pos] = coo.col[order]
    p_vals[coo.row[order], pos] = coo.data[order]

    # restrict table: per coarse column, its fine rows + weights
    dp = int(np.bincount(coo.col, minlength=nc).max())
    pt_rows = np.full((nc, dp), n, dtype=np.int64)
    pt_vals = np.zeros((nc, dp), dtype=np.float64)
    order_c = np.argsort(coo.col, kind="stable")
    starts_c = np.concatenate([[0], np.cumsum(np.bincount(coo.col, minlength=nc))])
    pos_c = np.arange(coo.nnz) - starts_c[coo.col[order_c]]
    pt_rows[coo.col[order_c], pos_c] = coo.row[order_c]
    pt_vals[coo.col[order_c], pos_c] = coo.data[order_c]

    def real(a):
        return torch.as_tensor(a, dtype=ell.dtype, device=ell.device)

    return SmoothedTwoLevel(
        inv_diag=real(1.0 / np.where(D != 0, D, 1.0)),
        p_cols=torch.as_tensor(p_cols, device=ell.device),
        p_vals=real(p_vals),
        pt_rows=torch.as_tensor(pt_rows, device=ell.device),
        pt_vals=real(pt_vals),
        coarse_inv=real(Ac_inv),
    )


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
