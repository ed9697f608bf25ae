"""Block-sparse (BSR) operators for the PCG hot loop.

Counterpart of ``pytorch_fem_solver_tpu/ops/bsr.py``. The reduced operator
is stored as 8x8 blocks with the unknowns spatially reordered and laid out
as ``(n/8, 8)``:

    y_block[r] = sum_b  A[r, b] (8x8)  @  x2[bcols[r, b]] (8,)

Host-side structure building is NumPy, byte-identical to the JAX package
(same ``spatial_order``, same native pair-rank kernel or NumPy fallback);
the finished tables move to the device once. The per-iteration SpMV is the
hand-written CUDA kernel ``csrc/bsr_spmv.cu`` (``bsr_spmv``), with its plain
PyTorch version (``_bsr_spmv_plain``) beside it for CPU tensors. The
multi-column product of the Stokes solvers (``bsr_matvec_cols``) launches
it once per column on the card.

Values stored in a reduced dtype (bf16: ``compiled_bsr_solver(values_dtype=
...)``, the inner copy of the multiplicative cycle) multiply an x of
another dtype as the JAX package's ``bsr_matvec`` does: x is rounded to
the values' dtype and the products are summed in x's dtype. On the card
bf16 values with float32 or float64 x launch K2's bf16-values
instantiation; no other pair of dtypes has a kernel.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import config
from ..utils.profiling import count, span
from . import cuda_build


class BSRStructure(NamedTuple):
    """Static (host-built) block-sparse layout for a reduced FEM operator.

    The reduced system is permuted by ``perm`` (spatial ordering) and padded
    to ``n_pad`` (identity rows); all device tables index the permuted,
    padded numbering. With ``max_b`` set, block-rows touching more than
    ``max_b`` neighbour blocks spill their excess blocks into a small second
    tier (``bcols2``/``heavy_rows``). Both tiers are padded to their widths;
    a block-row's slots are filled from the front (tier 1, then its tier-2
    row), so ``row_blocks`` says where the stored blocks end. ``row_blocks``
    and ``heavy_rank`` are tables of this package alone (the SpMV kernel
    reads them to skip the padding); every other table is the JAX
    package's, byte for byte.
    """

    bcols: torch.Tensor  # (nb, B) block-column ids; own block at b=0; pad -> 0
    entry_slot: torch.Tensor  # (T*n_loc^2,) value slot per flat element entry;
    #   entries touching Dirichlet DOFs point at n_values (dropped)
    perm: np.ndarray  # (n_inner,) permuted position -> original reduced id
    inner_perm: np.ndarray  # (n_inner,) global DOF id at each permuted slot
    n_inner: int
    n_pad: int
    nb: int
    block: int
    n_values: int  # total value slots: (nb * B + nh * B2) * block^2
    bcols2: torch.Tensor  # (nh, B2) spilled block-column ids (nh = 0: no tier)
    heavy_rows: torch.Tensor  # (nh,) block-rows owning the spilled blocks
    entry_slot_sym: torch.Tensor = None  # (T*n_loc*(n_loc+1)/2,) canonical-
    #   pair slots for symmetric assembly (drop slot on Dirichlet entries)
    tpartner: torch.Tensor = None  # (S_blocks,) mirror block id per block
    ubr_host: np.ndarray = None  # (n_blocks,) host block-row of stored blocks
    ubc_host: np.ndarray = None  # (n_blocks,) host block-col of stored blocks
    blk_id_host: np.ndarray = None  # (n_blocks,) host flat value-block id
    row_blocks: torch.Tensor = None  # (nb,) stored blocks per block-row, both
    #   tiers: the first min(count, B) in tier 1, the rest in tier 2
    heavy_rank: torch.Tensor = None  # (nb,) the block-row's row of tier 2
    #   (its index in heavy_rows), -1 where it spills nothing
    inner_perm_index: torch.Tensor = None  # (n_inner,) int64 device copy of
    #   inner_perm, the gather/scatter index of bsr_reduce and bsr_expand
    tpartner_index: torch.Tensor = None  # (S_blocks,) int64 device copy of
    #   tpartner, the gather index of bsr_complete_symmetric
    tperm: torch.Tensor = None  # (block^2,) int64: the in-block transpose


def spatial_order(coords: np.ndarray, group: int = 32) -> np.ndarray:
    """Coordinate-bisection ordering with group-aligned splits.

    Returns a permutation such that every consecutive ``group``-sized range
    of the new order is a spatially compact cluster (split points are
    multiples of ``group``, so clusters never straddle a range boundary).
    """
    coords = np.asarray(coords)
    n = coords.shape[0]
    perm = np.empty(n, dtype=np.int64)
    out = 0

    stack = [np.arange(n)]
    while stack:
        idx = stack.pop()
        if idx.size <= group:
            perm[out : out + idx.size] = idx
            out += idx.size
            continue
        spans = coords[idx].max(0) - coords[idx].min(0)
        ax = int(np.argmax(spans))
        order = idx[np.argsort(coords[idx, ax], kind="stable")]
        # split at a group multiple nearest the median so every completed
        # left part is whole groups
        half = max(group, ((idx.size // 2) // group) * group)
        # LIFO stack: push right first so the left half is emitted first
        stack.append(order[half:])
        stack.append(order[:half])
    return perm


def row_tables(ubr: np.ndarray, nb: int, heavy_rows: np.ndarray):
    """``(row_blocks, heavy_rank)`` of a structure, as host int64 arrays,
    from the block-row of every stored block and the sorted tier-2 rows."""
    row_blocks = np.bincount(np.asarray(ubr, dtype=np.int64), minlength=nb)
    heavy_rows = np.asarray(heavy_rows, dtype=np.int64)
    heavy_rank = np.full(nb, -1, dtype=np.int64)
    heavy_rank[heavy_rows] = np.arange(heavy_rows.size)
    return row_blocks, heavy_rank


def index_tables(inner_perm: np.ndarray, tpartner: np.ndarray, block: int) -> dict:
    """The structure's int64 gather tables as host arrays: ``inner_perm``,
    ``tpartner`` and the ``block`` x ``block`` transpose map ``tperm``."""
    return {
        "inner_perm_index": np.asarray(inner_perm, dtype=np.int64),
        "tpartner_index": np.asarray(tpartner, dtype=np.int64),
        "tperm": np.arange(block * block).reshape(block, block).T.reshape(-1),
    }


def build_bsr_structure(
    dofs,
    n_dofs: int,
    inner,
    coords,
    block: int = 8,
    pad_to: int = 32,
    leaf: int = 32,
    max_b: int | None = None,
    want_entry_slot: bool = True,
    *,
    device=None,
) -> BSRStructure:
    """Host-side construction of the permuted block-sparse layout.

    Args:
      dofs: (T, n_loc) global DOF ids per cell.
      n_dofs: total global DOF count.
      inner: (n_inner,) interior DOF ids (Dirichlet eliminated).
      coords: (n_inner, d) coordinates of the interior DOFs, used for the
        spatial reordering that gives block locality.
      block: block edge.
      pad_to: pad the permuted system to a multiple of this.
      leaf: spatial-bisection cluster size for the ordering.
      max_b: cap on neighbour blocks per block-row in tier 1; rows over the
        cap spill the excess blocks to the second tier. None = no cap.
      want_entry_slot: build the full per-entry scatter table used by the
        non-symmetric assembly (``bsr_values_from_local``).
      device: where the device tables go (default: the card).
    """
    device = config.resolve_device(device)
    dofs = np.asarray(dofs).reshape(-1, np.asarray(dofs).shape[-1])
    inner = np.asarray(inner)
    coords = np.asarray(coords)
    n_loc = dofs.shape[1]
    n_inner = int(inner.size)

    perm = spatial_order(coords, group=leaf)
    inner_perm = inner[perm]

    pad_to = int(np.lcm(np.lcm(block, pad_to), leaf))
    # round n_pad up so every power-of-two aggregate multiple divides it
    # (see the JAX package's note on the 245k-DOF degenerate coarse level)
    n0 = -(-max(n_inner, 1) // pad_to) * pad_to
    mult = -(-n0 // (4096 * 4 * block))  # 4*block = the base aggregate
    pad_to *= 1 << max(int(mult - 1).bit_length() + 2, 2)
    n_pad = -(-max(n_inner, 1) // pad_to) * pad_to
    nb = n_pad // block

    new_id = np.full(n_dofs, -1, dtype=np.int64)
    new_id[inner_perm] = np.arange(n_inner)

    # per ORIGINAL flat entry: ascending-unique-block rank (-1 = dropped)
    # and in-block position; native kernel or byte-identical NumPy fallback
    from ..native import bsr_pair_ranks as native_bsr_pair_ranks

    native_pr = native_bsr_pair_ranks(dofs, new_id, block, nb)
    if native_pr is not None:
        rank_all, in_block_all, bkeys, rank_sym_n, in_block_sym_n = native_pr
    else:
        rank_sym_n = in_block_sym_n = None
        rows = new_id[np.repeat(dofs, n_loc, axis=1).reshape(-1)]
        cols = new_id[np.tile(dofs, (1, n_loc)).reshape(-1)]
        valid = (rows >= 0) & (cols >= 0)
        in_block_all = np.where(
            valid, (rows % block) * block + (cols % block), 0
        )
        kept = np.nonzero(valid)[0]
        bkeys, inv = np.unique(
            (rows[kept] // block) * nb + cols[kept] // block,
            return_inverse=True,
        )
        rank_all = np.full(rows.size, -1, dtype=np.int64)
        rank_all[kept] = inv.reshape(-1)
    ubr = bkeys // nb
    ubc = bkeys % nb
    counts = np.bincount(ubr, minlength=nb)
    B_full = max(1, int(counts.max(initial=0)))
    if max_b is not None and int(max_b) < 1:
        raise ValueError(f"max_b must be >= 1, got {max_b}")
    B = B_full if max_b is None else min(B_full, int(max_b))

    starts = np.concatenate([[0], np.cumsum(counts)])
    b_of = np.arange(bkeys.size) - starts[ubr]
    # swap each row's diagonal block into position 0 so the Jacobi diagonal
    # and the padded identity rows always live at b=0
    diag = ubr == ubc
    diag_pos = np.zeros(nb, dtype=np.int64)
    diag_pos[ubr[diag]] = b_of[diag]
    b_of = np.where(diag, 0, np.where(b_of == 0, diag_pos[ubr], b_of))

    bcols = np.zeros((nb, B), dtype=np.int64)
    bcols[:, 0] = np.arange(nb)  # empty block-rows keep a harmless self ref
    tier1 = b_of < B
    bcols[ubr[tier1], b_of[tier1]] = ubc[tier1]

    # second tier: the spilled blocks of heavy rows, compacted to (nh, B2)
    heavy_rows = np.unique(ubr[~tier1])
    nh = heavy_rows.size
    B2 = max(int(counts.max(initial=0)) - B, 0) if nh else 0
    heavy_rank = np.zeros(nb, dtype=np.int64)
    heavy_rank[heavy_rows] = np.arange(nh)
    bcols2 = np.zeros((nh, B2), dtype=np.int64)
    bcols2[heavy_rank[ubr[~tier1]], b_of[~tier1] - B] = ubc[~tier1]

    # flat block id per unique pair: tier-1 ids first, tier-2 past them
    n_values1 = nb * B * block * block
    blk_id = np.where(
        b_of < B,
        ubr * B + b_of,
        nb * B + heavy_rank[ubr] * B2 + (b_of - B),
    )
    # all-Dirichlet meshes have zero stored blocks; keep the gathers below
    # legal (every rank is -1, so the padded id is masked to n_values)
    blk_id_safe = blk_id if blk_id.size else np.zeros(1, dtype=np.int64)

    n_values = int(n_values1 + nh * B2 * block * block)
    if want_entry_slot:
        # slot of every element entry in ORIGINAL order; boundary-touching
        # entries point one past the end and are dropped by the scatter
        entry_slot = np.where(
            rank_all >= 0,
            blk_id_safe[np.maximum(rank_all, 0)] * (block * block)
            + in_block_all,
            n_values,
        )
    else:
        entry_slot = np.zeros((0,), dtype=np.int64)

    # symmetric-assembly tables: one slot per unordered local DOF pair in
    # its canonical (row-block <= col-block) position
    if rank_sym_n is not None:
        rank_s, in_block_s = rank_sym_n, in_block_sym_n
    else:
        iu, ju = np.triu_indices(n_loc)
        g_i = new_id[dofs[:, iu]]  # (T, P)
        g_j = new_id[dofs[:, ju]]
        sel = np.where(g_i <= g_j, iu * n_loc + ju, ju * n_loc + iu)
        flat = np.arange(dofs.shape[0])[:, None] * (n_loc * n_loc) + sel
        rank_s = rank_all[flat].reshape(-1)
        in_block_s = (
            (np.minimum(g_i, g_j) % block) * block
            + (np.maximum(g_i, g_j) % block)
        ).reshape(-1)
        rank_s = np.where(((g_i >= 0) & (g_j >= 0)).reshape(-1), rank_s, -1)
    entry_slot_sym = np.where(
        rank_s >= 0,
        blk_id_safe[np.maximum(rank_s, 0)] * (block * block) + in_block_s,
        n_values,
    )

    # block-transpose partner: mirror (cb, rb) of every stored block (self
    # for diagonals); padding slots stay self-paired so they remain zero
    trank = np.searchsorted(bkeys, ubc * nb + ubr)
    S_blocks = nb * B + nh * B2
    tpartner = np.arange(S_blocks, dtype=np.int64)
    tpartner[blk_id] = blk_id[trank]

    row_blocks, spill_row = row_tables(ubr, nb, heavy_rows)

    def dev(a):
        return torch.as_tensor(
            np.asarray(a).astype(np.int32), dtype=config.index_dtype(),
            device=device,
        )

    gathers = {
        name: torch.as_tensor(a, dtype=torch.int64, device=device)
        for name, a in index_tables(inner_perm, tpartner, block).items()
    }
    return BSRStructure(
        bcols=dev(bcols),
        entry_slot=dev(entry_slot),
        perm=perm,
        inner_perm=inner_perm,
        n_inner=n_inner,
        n_pad=int(n_pad),
        nb=int(nb),
        block=int(block),
        n_values=n_values,
        bcols2=dev(bcols2),
        heavy_rows=dev(heavy_rows),
        entry_slot_sym=dev(entry_slot_sym),
        tpartner=dev(tpartner),
        ubr_host=ubr,
        ubc_host=ubc,
        blk_id_host=blk_id,
        row_blocks=dev(row_blocks),
        heavy_rank=dev(spill_row),
        **gathers,
    )


# -- kernel K8: the scatter-add into the values, with a sink -----------------

#: the largest n_loc K8's pair scatter takes: each CTA holds the call's table
#: of n_loc (n_loc + 1) / 2 int64 offsets in at most 227 KiB of shared memory
#: (``csrc/pair_scatter.cu``)
PAIR_SCATTER_MAX_LOC = 240
_PAIR_SCATTER_ARGTYPES = (
    [ctypes.c_void_p] + [ctypes.c_int64] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int64,
                                                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
)
_FLAT_SCATTER_ARGTYPES = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
                          ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
_SLOT_SUFFIX = {torch.int32: "i32", torch.int64: "i64"}


def _k8_slots(entry: str, data, slots, values):
    """Raise unless K8's ``entry`` can add the CUDA tensor ``data`` at
    ``slots`` into ``values``: float32 or float64 data that needs no
    gradient (K8 adds outside autograd), int32 or int64 slots on its device,
    and a contiguous buffer of its dtype on its device. Returns the slots,
    contiguous."""
    if data.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{entry}: K8 takes float32 or float64, got {data.dtype}")
    if slots.dtype not in _SLOT_SUFFIX:
        raise TypeError(f"{entry}: K8 takes int32 or int64 slots, got {slots.dtype}")
    if torch.is_grad_enabled() and (data.requires_grad or values.requires_grad):
        raise RuntimeError(
            f"{entry}: K8 adds outside autograd; scatter tensors that need a gradient on the CPU"
        )
    for name, t in (("slots", slots), ("values", values)):
        if t.device != data.device:
            raise ValueError(f"{entry}: {name} on {t.device}, the values added on {data.device}")
    cuda_build.check(values, "values", values.shape, data.dtype)
    return slots.contiguous()


def _launch_k8(entry: str, argtypes, slots, data, *args) -> None:
    """One launch of K8's ``entry`` (``pair_scatter`` or ``flat_scatter``)
    for ``slots``' and ``data``'s dtypes, on the current stream; counted
    under ``entry``."""
    fn = cuda_build.function(
        "pair_scatter", f"{entry}_{_SLOT_SUFFIX[slots.dtype]}", data.dtype, argtypes
    )
    err = fn(*args, torch.cuda.current_stream(data.device).cuda_stream)
    cuda_build.raise_on_error(err, entry)
    cuda_build.launch_counts[entry] += 1


def _scatter_drop(slots, data, n: int):
    """``zeros(n).at[slots].add(data, mode="drop")``: slots equal to ``n``
    land in a sink one past the end, which is sliced off.

    CPU tensors add with ``index_add_``. CUDA tensors launch K8's flat
    scatter (one launch), which adds each value whose slot lies in
    ``[0, n)`` and skips the rest, the sink among them, which stays 0; it
    raises for slots and values that are not 1-D of one length, and where
    ``_k8_slots`` does. Counts ``scatter_values`` and, where K8 took them,
    ``scatter_kernel_values``.
    """
    out = torch.zeros(n + 1, dtype=data.dtype, device=data.device)
    count("scatter_values", data.numel())
    if data.device.type == "cpu":
        return out.index_add_(0, slots, data)[:n]
    if data.dim() != 1 or slots.dim() != 1 or slots.shape[0] != data.shape[0]:
        raise ValueError(
            f"_scatter_drop: 1-D slots and values of one length expected, got "
            f"{tuple(slots.shape)} and {tuple(data.shape)}"
        )
    slots = _k8_slots("flat_scatter", data, slots, out)
    if data.shape[0]:
        _launch_k8("flat_scatter", _FLAT_SCATTER_ARGTYPES, slots, data, data.data_ptr(),
                   data.stride(0), slots.data_ptr(), data.shape[0], out.data_ptr(), n)
    count("scatter_kernel_values", data.shape[0])
    return out[:n]


def bsr_values_from_local(structure: BSRStructure, local_matrices):
    """Assemble element matrices into the block layout.

    One scatter-add in original entry order; boundary-touching entries are
    dropped. Returns ``(tier1, tier2)``: ``(nb, B, k, k)`` and
    ``(nh, B2, k, k)``.
    """
    values = _scatter_drop(
        structure.entry_slot, local_matrices.reshape(-1), structure.n_values
    )
    nb, B = structure.bcols.shape
    nh, B2 = structure.bcols2.shape
    k = structure.block
    split = nb * B * k * k
    return (
        values[:split].reshape(nb, B, k, k),
        values[split:].reshape(nh, B2, k, k),
    )


def bsr_values_from_local_symmetric(structure: BSRStructure, local_matrices):
    """Assemble *symmetric* element matrices with 1/3 fewer scattered entries.

    Scatters one value per unordered local DOF pair into the canonical
    (row-block <= col-block) slot, then completes every mirror block
    (``bsr_complete_symmetric``). Only valid for symmetric local matrices.
    """
    values = bsr_add_pairs_symmetric(structure, None, structure.entry_slot_sym, local_matrices)
    return bsr_complete_symmetric(structure, values[: structure.n_values])


def bsr_add_pairs_symmetric(structure: BSRStructure, values, slots, local_matrices):
    """Add one run of cells' canonical pairs (its element matrices and its
    rows of ``entry_slot_sym``) into the buffer ``values`` of ``n_values +
    1`` slots, the last the sink of the Dirichlet-touching pairs (None: a
    new one), and return it. Runs over the whole mesh, summed in one buffer,
    let the element matrices of the whole mesh never exist at once;
    ``bsr_complete_symmetric`` of the first ``n_values`` slots ends the
    assembly.

    CPU tensors copy the pairs out, the diagonal halved, and add them with
    ``index_add_``; the pairs are not held past the call, through the
    completion, whose copies set the peak. CUDA tensors launch K8's pair
    scatter (one launch), which reads each pair in place from the element
    matrices and adds it unless its slot is the sink, which stays 0; it
    raises for n_loc above ``PAIR_SCATTER_MAX_LOC`` and where ``_k8_slots``
    does. Refuses element matrices that are not square and slots or a
    buffer of the wrong length. Counts ``scatter_values`` and, where K8
    took them, ``scatter_kernel_values``."""
    n_loc = local_matrices.shape[-1]
    if local_matrices.dim() < 2 or local_matrices.shape[-2] != n_loc:
        raise ValueError(
            "bsr_add_pairs_symmetric: (..., n_loc, n_loc) element matrices expected, got "
            f"{tuple(local_matrices.shape)}"
        )
    n_pairs = n_loc * (n_loc + 1) // 2
    n_cells = local_matrices.numel() // (n_loc * n_loc) if n_loc else 0
    if slots.dim() != 1 or slots.shape[0] != n_cells * n_pairs:
        raise ValueError(
            f"bsr_add_pairs_symmetric: {n_cells} cells of {n_pairs} pairs need "
            f"{n_cells * n_pairs} slots, got shape {tuple(slots.shape)}"
        )
    if values is not None and tuple(values.shape) != (structure.n_values + 1,):
        raise ValueError(
            f"bsr_add_pairs_symmetric: values must have shape ({structure.n_values + 1},), "
            f"got {tuple(values.shape)}"
        )
    count("scatter_values", slots.shape[0])
    if values is None:
        values = local_matrices.new_zeros(structure.n_values + 1)
    if local_matrices.device.type != "cpu":
        if n_loc > PAIR_SCATTER_MAX_LOC:
            raise ValueError(
                f"bsr_add_pairs_symmetric: n_loc = {n_loc} > {PAIR_SCATTER_MAX_LOC}, the "
                "largest whose table of pairs one CTA of K8 holds"
            )
        slots = _k8_slots("pair_scatter", local_matrices, slots, values)
        local = local_matrices.reshape(n_cells, n_loc, n_loc)  # a view of a (T, n, n) run
        if n_cells:
            _launch_k8("pair_scatter", _PAIR_SCATTER_ARGTYPES, slots, local, local.data_ptr(),
                       *local.stride(), n_loc, slots.data_ptr(), slots.shape[0],
                       values.data_ptr(), structure.n_values)
        count("scatter_kernel_values", slots.shape[0])
        return values
    iu, ju = torch.triu_indices(n_loc, n_loc, device=local_matrices.device)
    # local (i, i) pairs are exactly the global diagonal scalars, which
    # the self-partnered transpose doubles: halve them before the scatter
    w = torch.where(iu == ju, 0.5, 1.0).to(local_matrices.dtype)
    pairs = (local_matrices[..., iu, ju] * w).reshape(-1)
    return values.index_add_(0, slots, pairs)


def bsr_complete_symmetric(structure: BSRStructure, values):
    """Mirror-complete canonically scattered symmetric values.

    ``values`` is the flat (n_values,) buffer holding each unordered DOF
    pair's contribution in its canonical slot, with the scalar diagonal
    pre-halved. Each 64-wide block row gets its partner's transpose added.
    """
    k = structure.block
    nb, B = structure.bcols.shape
    nh, B2 = structure.bcols2.shape
    flat = values.reshape(-1, k * k)
    full = flat + flat[structure.tpartner_index][:, structure.tperm]
    v1 = full[: nb * B].reshape(nb, B, k, k)
    v2 = full[nb * B :].reshape(nh, B2, k, k)
    return v1, v2


# -- kernel K2: BSR SpMV -----------------------------------------------------

_SPMV_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]


def _widen(v1, v2, x):
    """The operands of a product of ``v1``/``v2`` with ``x`` in ``x``'s
    dtype: unchanged for equal dtypes, else x rounded to the values' dtype
    and all three widened to x's dtype (exact products for bf16 values:
    the JAX package's ``preferred_element_type=x.dtype``)."""
    if v1.dtype == x.dtype:
        return v1, v2, x
    out = x.dtype
    return v1.to(out), v2.to(out), x.to(v1.dtype).to(out)


def _bsr_spmv_plain(bcols, v1, x, bcols2, v2, heavy_rows):
    """Plain PyTorch version of K2: gather + einsum, as the JAX
    ``bsr_matvec`` computes it (own block by reshape, neighbours by
    gather, tier-2 rows added back at the unique ``heavy_rows``), for any
    pair of value and x dtypes (``_widen``). It walks every slot, padding
    included: padded slots hold zero values. An ``x`` longer than the rows
    (a block-row slice against the whole iterate) gives the own blocks by
    their column, ``bcols[:, 0]``, too."""
    v1, v2, x = _widen(v1, v2, x)
    nb, _, k, _ = v1.shape
    x2 = x.reshape(-1, k)
    xo = x2 if x2.shape[0] == nb else x2[bcols[:, 0].long()]
    y = torch.einsum("rij,rj->ri", v1[:, 0], xo)
    y = y + torch.einsum("rbij,rbj->ri", v1[:, 1:], x2[bcols[:, 1:].long()])
    if heavy_rows.shape[0]:
        y2 = torch.einsum("rbij,rbj->ri", v2, x2[bcols2.long()])
        y = y.index_add(0, heavy_rows.long(), y2)
    return y.reshape(-1)


def bsr_spmv(bcols, v1, x, bcols2, v2, heavy_rows, row_blocks=None, heavy_rank=None):
    """y = A x over the permuted, padded vector (kernel K2).

    CPU tensors take ``_bsr_spmv_plain``. CUDA tensors launch
    ``csrc/bsr_spmv.cu`` once or raise: a warp per block-row sums the row's
    ``row_blocks[r]`` stored blocks, the first ``B`` of them from tier 1 and
    the rest from row ``heavy_rank[r]`` of tier 2, and reads no padded slot
    (``heavy_rows`` is the plain version's table; the kernel does not read
    it). ``y`` is bitwise the same on every launch. ``x`` may be longer than
    the ``nb`` block-rows (a shard's row slice of the operator against the
    gathered iterate: the kernel reads ``x`` only through the block
    columns); ``y`` has the rows' ``nb * 8`` entries. Values and ``x`` of one
    dtype (float32, float64) launch K2 counted under ``"bsr_spmv"``; bf16
    values with float32 or float64 ``x`` launch its bf16-values
    instantiation, counted under ``"bsr_spmv_bf16"``; any other pair raises
    ``TypeError``.
    """
    if x.device.type == "cpu":
        return _bsr_spmv_plain(bcols, v1, x, bcols2, v2, heavy_rows)
    bf16 = v1.dtype != x.dtype
    if bf16 and not (
        v1.dtype == torch.bfloat16 and x.dtype in (torch.float32, torch.float64)
    ):
        raise TypeError(
            f"the SpMV kernel takes values and x of one dtype, or bfloat16 values "
            f"with float32 or float64 x; got {v1.dtype} values with {x.dtype} x"
        )
    nb, B, k, _ = v1.shape
    nh, B2 = bcols2.shape
    if k != 8 or v1.shape[-1] != 8:
        raise ValueError(f"the SpMV kernel takes 8x8 blocks, got {k}x{v1.shape[-1]}")
    if row_blocks is None or heavy_rank is None:
        raise ValueError(
            "the SpMV kernel needs the structure's row_blocks and heavy_rank tables"
        )
    n_x = x.shape[0] if x.dim() == 1 else -1
    if n_x < nb * k or n_x % k:
        raise ValueError(
            f"x must be 1-D with a multiple of {k} and at least {nb * k} entries, "
            f"got shape {tuple(x.shape)}"
        )
    cuda_build.check(x, "x", (n_x,), x.dtype, align=16)
    cuda_build.check(v1, "v1", (nb, B, k, k), v1.dtype, align=16)
    cuda_build.check(bcols, "bcols", (nb, B), torch.int32)
    cuda_build.check(v2, "v2", (nh, B2, k, k), v1.dtype, align=16)
    cuda_build.check(bcols2, "bcols2", (nh, B2), torch.int32)
    cuda_build.check(row_blocks, "row_blocks", (nb,), torch.int32)
    cuda_build.check(heavy_rank, "heavy_rank", (nb,), torch.int32)
    y = x.new_empty(nb * k)
    fn = cuda_build.function("bsr_spmv", "bsr_spmv", v1.dtype, _SPMV_ARGTYPES, x.dtype)
    err = fn(
        bcols.data_ptr(), v1.data_ptr(), bcols2.data_ptr(), v2.data_ptr(),
        row_blocks.data_ptr(), heavy_rank.data_ptr(), x.data_ptr(), y.data_ptr(),
        nb, B, B2, torch.cuda.current_stream(x.device).cuda_stream,
    )
    key = "bsr_spmv_bf16" if bf16 else "bsr_spmv"
    cuda_build.raise_on_error(err, key)
    cuda_build.launch_counts[key] += 1
    return y


def bsr_matvec(structure: BSRStructure, values, x):
    """y = A @ x through the SpMV kernel (K2).

    ``x`` is the permuted padded vector (n_pad,). Values stored in another
    dtype (bf16) meet an ``x`` rounded to it, and the sums run in ``x``'s
    dtype (see ``bsr_spmv`` for the pairs the card takes).
    """
    v1, v2 = values
    return bsr_spmv(
        structure.bcols, v1, x, structure.bcols2, v2, structure.heavy_rows,
        structure.row_blocks, structure.heavy_rank,
    )


def _bsr_spmv_cols_plain(bcols, v1, X, bcols2, v2, heavy_rows):
    """Plain version of K2 on an (n_pad, m) block: the JAX
    ``bsr_matvec_cols`` (two einsums over the column axis and the tier-2
    rows added back at ``heavy_rows``), any pair of dtypes (``_widen``)."""
    v1, v2, X = _widen(v1, v2, X)
    nb, _, k, _ = v1.shape
    m = X.shape[-1]
    x2 = X.reshape(nb, k, m)
    y = torch.einsum("rij,rjm->rim", v1[:, 0], x2)
    y = y + torch.einsum("rbij,rbjm->rim", v1[:, 1:], x2[bcols[:, 1:].long()])
    if heavy_rows.shape[0]:
        y2 = torch.einsum("rbij,rbjm->rim", v2, x2[bcols2.long()])
        y = y.index_add(0, heavy_rows.long(), y2)
    return y.reshape(-1, m)


def bsr_matvec_cols(structure: BSRStructure, values, X):
    """Y = A @ X for a multi-column operand X (n_pad, m): the
    component-decoupled Stokes A block, the scalar operator on the
    ``n_components`` columns at once.

    CPU tensors take ``_bsr_spmv_cols_plain``. CUDA tensors launch K2 once
    per column, on a contiguous copy of it (``bsr_matvec``); a kernel that
    reads the values once for all m columns is queued (ROADMAP.md, B8).
    Mixed dtypes follow ``bsr_matvec``.
    """
    v1, _ = values
    if X.device.type == "cpu":
        return _bsr_spmv_cols_plain(
            structure.bcols, v1, X, structure.bcols2, values[1], structure.heavy_rows
        )
    return torch.stack([bsr_matvec(structure, values, c) for c in X.T.contiguous()], dim=1)


def bsr_diagonal(structure: BSRStructure, values):
    """Operator diagonal (own block is always at b=0); padded rows -> 0."""
    return torch.diagonal(values[0][:, 0], dim1=-2, dim2=-1).reshape(-1)


def bsr_reduce(structure: BSRStructure, b):
    """Full load vector (n_dofs,...) -> permuted padded reduced rhs (n_pad,)."""
    red = b.reshape(-1)[structure.inner_perm_index]
    return torch.nn.functional.pad(red, (0, structure.n_pad - structure.n_inner))


def bsr_reduce_cols(structure: BSRStructure, B):
    """Multi-column twin of :func:`bsr_reduce`: (n_dofs, m) -> (n_pad, m)."""
    red = B[structure.inner_perm_index]
    return torch.nn.functional.pad(red, (0, 0, 0, structure.n_pad - structure.n_inner))


def bsr_expand_cols(structure: BSRStructure, X, n_dofs: int):
    """Multi-column twin of :func:`bsr_expand`: (n_pad, m) -> (n_dofs, m)."""
    full = X.new_zeros((n_dofs, X.shape[-1]))
    full[structure.inner_perm_index] = X[: structure.n_inner]
    return full


def inverse_inner_perm(
    structure: BSRStructure, n_dofs: int, sentinel: int | None = None
):
    """Host map dof -> position in the permuted padded reduced vector.

    DOFs not in ``inner_perm`` (boundary/eliminated) map to ``sentinel``
    (default ``n_pad``, one past the end, so drop-mode scatters discard
    them).
    """
    inner_perm = np.asarray(structure.inner_perm)
    if sentinel is None:
        sentinel = structure.n_pad
    inv = np.full((int(n_dofs),), sentinel, dtype=np.int64)
    inv[inner_perm] = np.arange(inner_perm.shape[0], dtype=np.int64)
    return inv


def bsr_expand(structure: BSRStructure, x, n_dofs: int):
    """Permuted padded solution (n_pad,) -> full DOF vector (n_dofs, 1)."""
    full = torch.zeros((n_dofs,), dtype=x.dtype, device=x.device)
    full[structure.inner_perm_index] = x[: structure.n_inner]
    return full[:, None]


def default_max_b(basis) -> int:
    """Dimension-aware tier-1 block cap: 8 for triangle (and DFN) bases,
    24 for tets, tracking the mean block degree of the reference element
    dimension."""
    ref_dim = int(basis._element.barycentric_grad.shape[-1])
    return 24 if ref_dim >= 3 else 8


def get_bsr_structure(
    basis,
    block: int = 8,
    leaf: int = 32,
    max_b: int | None = None,
    want_entry_slot: bool = True,
) -> BSRStructure:
    """Cached-per-basis BSR layout, keyed by (block, leaf, max_b), on the
    basis's device.

    A cached symmetric-only structure (built with ``want_entry_slot=False``)
    is rebuilt when a caller later needs the full entry table.
    """
    cache = getattr(basis, "_bsr_structures", None)
    if cache is None:
        cache = {}
        basis._bsr_structures = cache
    key = (block, leaf, max_b)
    structure = cache.get(key)
    if structure is not None and want_entry_slot and structure.entry_slot.numel() == 0:
        structure = None  # symmetric-only cached; rebuild with the table
    if structure is None:
        with span("fem.tables.bsr", always=True):
            inner = basis._as_host_index(basis._basis_parameters["inner_dofs"])
            coords = basis._coords4global_dofs.cpu().numpy()[inner]
            structure = build_bsr_structure(
                basis._as_host_index(basis._global_dofs4elements),
                basis.n_dofs,
                inner,
                coords,
                block=block,
                leaf=leaf,
                max_b=max_b,
                want_entry_slot=want_entry_slot,
                device=basis.device,
            )
        cache[key] = structure
    return structure
