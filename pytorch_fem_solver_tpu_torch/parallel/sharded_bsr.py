"""Row-sharded BSR assemble+solve: the multi-process twin of
``ops.compiled.compiled_bsr_solver``.

Counterpart of ``pytorch_fem_solver_tpu/parallel/sharded_bsr.py``. Every
rank of the process group builds the same host plan (``BSRShardPlan``,
byte-identical to the JAX package's tables) and moves only its own slices
to its device. What grows with n is sharded:

  matrix values      block-row slices (each rank owns nb_pad / n_shards
                     rows, tier 1 and the tier-2 spill of its rows)
  assembly           halo-duplicated cells: each rank integrates the cells
                     that touch its rows and scatters locally, with no
                     collective
  vectors            x, r, z and p live row-sharded; the SpMV gathers the
                     search direction with one tiled
                     ``all_gather_into_tensor`` per product and runs K2
                     (``csrc/bsr_spmv.cu``) on the rank's block rows
                     against the gathered iterate
  smoother           per-rank (gs, gs) aggregate-block inverses of local
                     values (the padding makes shards whole aggregates)
  coarse level       Galerkin partials summed by one (nc, nc)
                     ``all_reduce`` per solve; the dense inverse is
                     computed on every rank, and each applies its nc_local
                     rows after one ``all_gather`` of the restricted
                     residual

Per PCG iteration: one all-gather of the iterate, one of the restricted
residual, and the scalar all-reduces of the dots (``ops.solvers.pcg`` with
a group-summed ``dot``). On one rank every collective is a copy, and the
solve is the single-process aggregate-block PCG.
"""

from __future__ import annotations

import weakref
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..basis.abstract_basis import host
from ..ops.bsr import (
    _scatter_drop,
    bsr_expand,
    bsr_reduce,
    bsr_spmv,
    default_max_b,
    get_bsr_structure,
    inverse_inner_perm,
)
from ..ops.precondition import (
    _prolong,
    batched_small_inv,
    build_agg_block_table,
    default_aggregate_size,
    spd_inverse,
)
from ..ops.solvers import PCGInfo, pcg
from .sharding import _default_mesh, _group

__all__ = [
    "BSRShardPlan",
    "build_bsr_shard_plan",
    "get_bsr_shard_plan",
    "sharded_bsr_solver",
    "solve_pcg_sharded_bsr",
]

PRECONDITIONERS = ("auto", "two_level", "jacobi")


class BSRShardPlan(NamedTuple):
    """Host-built, value-independent tables of the row-sharded solve.

    The ``*_sh`` arrays are host NumPy, stacked per shard on the leading
    axis with the JAX package's shapes and dtypes, byte for byte. The last
    three fields are this package's: K2's per-row tables of the padded
    rows, and the per-rank device slices (``_shard_tables``).
    """

    st: object  # the BSRStructure (original padding)
    n_shards: int
    nb_pad: int  # block rows after shard/aggregate alignment padding
    rps: int  # block rows per shard
    g: int  # coarse aggregate size (fine DOFs)
    gs: int  # smoother block size (fine DOFs)
    nc: int
    nc_local: int
    ns_local: int  # smoother blocks per shard
    nh_max: int  # tier-2 rows per shard (padded max)
    T_max: int  # halo cells per shard (padded max)
    n_values_local: int
    cells_sh: np.ndarray  # (n_shards, T_max) global cell ids (pad: cell 0)
    slots_sh: np.ndarray  # (n_shards*T_max*n_loc^2,) local value slots
    bcols_sh: np.ndarray  # (nb_pad, B) global block columns (pad rows: 0)
    bcols2_sh: np.ndarray  # (n_shards*nh_max, B2)
    hrows_sh: np.ndarray  # (n_shards*nh_max,) local block-row; pad: rps
    agg_sh: np.ndarray  # (n_shards*ns_local, bpa, bpa) local block ids
    vec_slots_sh: np.ndarray  # (n_shards*T_max*n_loc,) local reduced row per
    #   (halo cell, i_loc); foreign/Dirichlet/pad -> rps*k
    owned_cells_sh: np.ndarray  # (n_shards*T_max,) bool: exactly-once owner
    row_blocks_sh: np.ndarray  # (nb_pad,) int32 stored blocks per row (pad 0)
    heavy_rank_sh: np.ndarray  # (nb_pad,) int32 the row's local tier-2 row, -1
    device_tables: dict  # (rank, device) -> _ShardTables


class _ShardTables(NamedTuple):
    """One rank's slices of a plan, on its device."""

    cells: torch.Tensor  # (T_max,) int64 halo cell ids
    slots: torch.Tensor  # (T_max*n_loc^2,) int64 local value slots
    bcols: torch.Tensor  # (rps, B) int32 global block columns
    bcols2: torch.Tensor  # (nh, B2) int32, the shard's real tier-2 rows only
    hrows: torch.Tensor  # (nh,) int64 their local block rows
    agg: torch.Tensor  # (ns_local, bpa, bpa) int64 local block ids
    row_blocks: torch.Tensor  # (rps,) int32
    heavy_rank: torch.Tensor  # (rps,) int32
    nh: int


def _local_block_ids(plan_args, blk):
    """Vectorized global flat block id -> (owner shard, local block id).

    Tier-1 block ``blk < nb*B`` lives at row ``blk // B``; a tier-2 block
    belongs to ``heavy[(blk - nb*B) // B2]``. Local layout per shard:
    ``[tier1 rows*B | tier2 h_local*B2]``.
    """
    nb, B, B2, heavy, h_local, rps = plan_args
    t1 = blk < nb * B
    row1 = np.minimum(blk // B, nb - 1)
    idx2 = np.maximum(blk - nb * B, 0)
    if heavy.size:
        h = np.minimum(idx2 // max(B2, 1), heavy.size - 1)
        row2 = heavy[h]
        l2 = rps * B + h_local[h] * B2 + idx2 % max(B2, 1)
    else:
        row2 = np.zeros_like(blk)
        l2 = np.zeros_like(blk)
    row = np.where(t1, row1, row2)
    owner = row // rps
    lblk = np.where(t1, (row1 - owner * rps) * B + blk % B, l2)
    return owner, lblk


def build_bsr_shard_plan(
    basis,
    n_shards: int,
    max_b: Optional[int] = None,
    g: Optional[int] = None,
    gs: Optional[int] = None,
) -> BSRShardPlan:
    """Host-side construction of every per-shard table (value-independent;
    cache through :func:`get_bsr_shard_plan`)."""
    if max_b is None:
        max_b = default_max_b(basis)
    st = get_bsr_structure(basis, max_b=max_b, want_entry_slot=True)
    k, nb = st.block, st.nb
    B = st.bcols.shape[1]
    nh, B2 = st.bcols2.shape
    heavy = host(st.heavy_rows).astype(np.int64)
    kk = k * k

    if g is None:
        g = default_aggregate_size(st)
    if gs is None:
        gs = 128 if (g % 128 == 0 and g > 128) else min(g, 128)
        if g % gs:
            gs = g  # non-power-of-two aggregate: keep smoother == aggregate
    if g % k or gs % k:
        raise ValueError(f"g={g} and gs={gs} must be multiples of block {k}")

    # pad block rows so every shard is a whole number of coarse aggregates
    # AND smoother blocks
    unit = n_shards * int(np.lcm(g, gs)) // k
    nb_pad = -(-nb // unit) * unit
    rps = nb_pad // n_shards
    n_pad = nb_pad * k
    nc = n_pad // g
    nc_local = nc // n_shards
    ns_local = (n_pad // gs) // n_shards
    bpa = gs // k

    # ---- tier-2 per-shard partition (heavy rows are sorted ascending) ----
    if nh:
        owner_h = heavy // rps
        counts_h = np.bincount(owner_h, minlength=n_shards)
        nh_max = int(counts_h.max())
        starts_h = np.concatenate([[0], np.cumsum(counts_h)])
        h_local = np.arange(nh) - starts_h[owner_h]
        hrows_sh = np.full((n_shards, nh_max), rps, dtype=np.int64)
        hrows_sh[owner_h, h_local] = heavy - owner_h * rps
        bcols2_sh = np.zeros((n_shards, nh_max, B2), dtype=np.int64)
        bcols2_sh[owner_h, h_local] = host(st.bcols2)
    else:
        nh_max = 0
        h_local = np.zeros(0, dtype=np.int64)
        hrows_sh = np.zeros((n_shards, 0), dtype=np.int64)
        bcols2_sh = np.zeros((n_shards, 0, B2), dtype=np.int64)

    n_blocks_local = rps * B + nh_max * B2
    n_values_local = n_blocks_local * kk
    plan_args = (nb, B, B2, heavy, h_local, rps)

    # ---- per-entry ownership and local slots ------------------------------
    es = host(st.entry_slot).astype(np.int64)
    dofs = host(basis._global_dofs4elements)
    n_loc = dofs.shape[-1]
    T = dofs.reshape(-1, n_loc).shape[0]
    n_loc2 = n_loc * n_loc
    if es.size != T * n_loc2:
        raise ValueError("entry_slot and the cell table disagree")
    valid = es < st.n_values
    blk = np.where(valid, es // kk, 0)
    inb = es % kk
    owner, lblk = _local_block_ids(plan_args, blk)
    owner = np.where(valid, owner, -1)
    lslot = lblk * kk + inb

    # ---- halo cell partition ----------------------------------------------
    flat_idx = np.arange(T * n_loc2)
    sel = owner >= 0
    cellidx = flat_idx // n_loc2
    keys = owner[sel] * T + cellidx[sel]
    keys_pairs = np.unique(keys)
    pair_owner = keys_pairs // T
    pair_cell = keys_pairs % T
    counts_c = np.bincount(pair_owner, minlength=n_shards)
    T_max = max(int(counts_c.max(initial=0)), 1)
    starts_c = np.concatenate([[0], np.cumsum(counts_c)])
    pos_in_shard = np.arange(keys_pairs.size) - starts_c[pair_owner]
    cells_sh = np.zeros((n_shards, T_max), dtype=np.int64)
    cells_sh[pair_owner, pos_in_shard] = pair_cell
    pair_rank = np.searchsorted(keys_pairs, keys)
    pos = pos_in_shard[pair_rank]
    slots_sh = np.full((n_shards, T_max * n_loc2), n_values_local, np.int64)
    slots_sh[owner[sel], pos * n_loc2 + flat_idx[sel] % n_loc2] = lslot[sel]

    # ---- per-shard residual-vector scatter ---------------------------------
    # (halo cell, i_loc) -> local reduced row when this shard owns the row:
    # every real (cell, i) entry has exactly one owning shard, whose halo
    # holds the cell (the (i, i) entry put it there)
    lrows = rps * k
    inv_pos = inverse_inner_perm(st, int(basis.n_dofs), sentinel=lrows * n_shards)
    d_sh = dofs.reshape(-1, n_loc)[cells_sh]  # (n_shards, T_max, n_loc)
    pos_v = inv_pos[d_sh]
    shard_col = np.arange(n_shards)[:, None, None]
    own_v = pos_v // lrows == shard_col
    real_cell = (np.arange(T_max)[None, :] < counts_c[:, None])[..., None]
    vec_slots = np.where(own_v & real_cell, pos_v - shard_col * lrows, lrows)

    # ---- exactly-once cell ownership ---------------------------------------
    # owner(cell) = shard of the cell's first inner row; cells with no inner
    # DOF contribute nothing to reduced quantities and get no owner
    pos_all = inv_pos[dofs.reshape(-1, n_loc)]  # (T, n_loc)
    first = pos_all.min(axis=1)
    cell_owner = np.where(first < lrows * n_shards, first // lrows, n_shards)
    owned_cells = (cell_owner[cells_sh] == np.arange(n_shards)[:, None]) & real_cell[..., 0]

    # ---- per-shard aggregate-block smoother tables -------------------------
    table_g = build_agg_block_table(st._replace(n_pad=n_pad, nb=nb_pad), gs)
    sentinel_g = nb * B + nh * B2
    tg = table_g.reshape(n_shards, ns_local, bpa, bpa)
    tvalid = tg < sentinel_g
    towner, tlocal = _local_block_ids(plan_args, np.where(tvalid, tg, 0))
    shard_ix = np.arange(n_shards)[:, None, None, None]
    if not np.all((towner == shard_ix) | ~tvalid):
        raise AssertionError("in-aggregate block owned by a foreign shard (padding misaligned)")
    agg_sh = np.where(tvalid, tlocal, n_blocks_local)

    # ---- K2's tables of the padded rows: counts, local tier-2 rows ---------
    row_blocks_sh = np.zeros(nb_pad, dtype=np.int32)
    row_blocks_sh[:nb] = host(st.row_blocks)
    heavy_rank_sh = np.full(nb_pad, -1, dtype=np.int32)
    heavy_rank_sh[heavy] = h_local

    i_t = np.int32 if n_values_local < 2**31 else np.int64
    return BSRShardPlan(
        st=st,
        n_shards=n_shards,
        nb_pad=nb_pad,
        rps=rps,
        g=g,
        gs=gs,
        nc=nc,
        nc_local=nc_local,
        ns_local=ns_local,
        nh_max=nh_max,
        T_max=T_max,
        n_values_local=n_values_local,
        cells_sh=cells_sh,
        slots_sh=slots_sh.reshape(-1).astype(i_t),
        bcols_sh=np.concatenate(
            [host(st.bcols).astype(np.int64), np.zeros((nb_pad - nb, B), dtype=np.int64)]
        ).astype(np.int32),
        bcols2_sh=bcols2_sh.reshape(n_shards * nh_max, B2).astype(np.int32),
        hrows_sh=hrows_sh.reshape(-1).astype(np.int32),
        agg_sh=agg_sh.reshape(n_shards * ns_local, bpa, bpa).astype(i_t),
        vec_slots_sh=vec_slots.reshape(-1).astype(np.int32),
        owned_cells_sh=owned_cells.reshape(-1),
        row_blocks_sh=row_blocks_sh,
        heavy_rank_sh=heavy_rank_sh,
        device_tables={},
    )


#: plans per basis, held beside the basis and not on it: a basis (or a
#: shard copy of it) carries no trace of a plan
_PLANS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def get_bsr_shard_plan(basis, n_shards: int, **kwargs) -> BSRShardPlan:
    """Cached-per-basis shard plan, keyed by (n_shards, kwargs)."""
    cache = _PLANS.setdefault(basis, {})
    key = (n_shards, tuple(sorted(kwargs.items())))
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = build_bsr_shard_plan(basis, n_shards, **kwargs)
    return plan


def _shard_tables(plan: BSRShardPlan, rank: int, device) -> _ShardTables:
    """Rank ``rank``'s slices of the plan on ``device`` (moved once)."""
    key = (rank, str(device))
    tables = plan.device_tables.get(key)
    if tables is None:
        rps, nh_max, ns = plan.rps, plan.nh_max, plan.ns_local
        n_loc2 = plan.slots_sh.size // (plan.n_shards * plan.T_max)
        hrows = plan.hrows_sh[rank * nh_max:(rank + 1) * nh_max]
        nh = int(np.count_nonzero(hrows != rps))
        rows = slice(rank * rps, (rank + 1) * rps)

        def dev(a, dtype):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

        tables = plan.device_tables[key] = _ShardTables(
            cells=dev(plan.cells_sh[rank], torch.int64),
            slots=dev(plan.slots_sh[rank * plan.T_max * n_loc2:(rank + 1) * plan.T_max * n_loc2],
                      torch.int64),
            bcols=dev(plan.bcols_sh[rows], torch.int32),
            bcols2=dev(plan.bcols2_sh[rank * nh_max:rank * nh_max + nh], torch.int32),
            hrows=dev(hrows[:nh], torch.int64),
            agg=dev(plan.agg_sh[rank * ns:(rank + 1) * ns], torch.int64),
            row_blocks=dev(plan.row_blocks_sh[rows], torch.int32),
            heavy_rank=dev(plan.heavy_rank_sh[rows], torch.int32),
            nh=nh,
        )
    return tables


def _scatter_local_values(plan, local_s, tables):
    """Per-rank value scatter (no collective): halo-cell element matrices
    (T_max, n_loc, n_loc) -> (tier-1 (rps, B, k, k), tier-2 (nh_max, B2,
    k, k), local point diagonal)."""
    st = plan.st
    k, kk = st.block, st.block * st.block
    B, B2 = st.bcols.shape[1], st.bcols2.shape[1]
    vals = _scatter_drop(tables.slots, local_s.reshape(-1), plan.n_values_local)
    v1 = vals[: plan.rps * B * kk].reshape(plan.rps, B, k, k)
    v2 = vals[plan.rps * B * kk:].reshape(plan.nh_max, B2, k, k)
    diag_local = torch.diagonal(v1[:, 0], dim1=-2, dim2=-1).reshape(-1)
    return v1, v2, diag_local


def _all_gather(x_local, group, n_shards):
    """The tiled all-gather of a row-sharded vector."""
    out = x_local.new_empty(x_local.shape[0] * n_shards)
    dist.all_gather_into_tensor(out, x_local, group=group)
    return out


def _shard_matvec(plan, group, v1, v2, tables):
    """Row-sharded SpMV: one tiled all-gather of the iterate, then K2 on
    this rank's ``rps`` block rows against it (the plain version on CPU
    tensors); only the shard's real tier-2 rows go to the product."""
    nh = tables.nh
    v2 = v2[:nh]

    def matvec(x_local):
        x_full = _all_gather(x_local, group, plan.n_shards)
        return bsr_spmv(
            tables.bcols, v1, x_full, tables.bcols2, v2, tables.hrows,
            tables.row_blocks, tables.heavy_rank,
        )

    return matvec


def _shard_two_level_precond(plan, group, rank, v1, v2, tables):
    """Per-rank two-level preconditioner (aggregate-block smoother and the
    row-sharded apply of the dense coarse inverse), from local values and
    one (nc, nc) all-reduce of the Galerkin partials."""
    st = plan.st
    k, kk = st.block, st.block * st.block
    rps = plan.rps
    g, gs, nc, nc_local = plan.g, plan.gs, plan.nc, plan.nc_local
    bpg, bpa = g // k, gs // k

    # smoother: (gs, gs) aggregate diagonal blocks from local values only
    flat = torch.cat([v1.reshape(-1, kk), v2.reshape(-1, kk), v1.new_zeros((1, kk))])
    rows = flat[tables.agg]  # (ns_local, bpa, bpa, kk)
    D = rows.reshape(-1, bpa, bpa, k, k).permute(0, 1, 3, 2, 4).reshape(-1, gs, gs)
    zero_d = torch.diagonal(D, dim1=-2, dim2=-1) == 0
    D = D + torch.eye(gs, dtype=D.dtype, device=D.device) * zero_d[:, None, :]
    inv_agg = batched_small_inv(D)

    # coarse Galerkin: partials + one (nc, nc) all-reduce per solve; the
    # inverse is computed on every rank, its apply is row-sharded
    nh = tables.nh
    rows_c = (rank * rps + torch.arange(rps, device=v1.device)) // bpg
    bins1 = (rows_c[:, None] * nc + tables.bcols.long() // bpg).reshape(-1)
    part = v1.new_zeros(nc * nc).index_add(0, bins1, v1.sum(dim=(-1, -2)).reshape(-1))
    if nh:
        hg = (rank * rps + tables.hrows) // bpg
        bins2 = (hg[:, None] * nc + tables.bcols2.long() // bpg).reshape(-1)
        part = part.index_add(0, bins2, v2[:nh].sum(dim=(-1, -2)).reshape(-1))
    dist.all_reduce(part, group=group)
    coarse = part.reshape(nc, nc)
    coarse = 0.5 * (coarse + coarse.T)
    shift = torch.clamp(torch.trace(coarse) / nc, min=1.0)
    coarse_inv = spd_inverse(
        coarse + 1e-7 * shift * torch.eye(nc, dtype=coarse.dtype, device=coarse.device)
    )
    coarse_rows = coarse_inv[rank * nc_local:(rank + 1) * nc_local]

    def precond(r_local):
        fine = torch.einsum("rij,rj->ri", inv_agg, r_local.reshape(-1, gs)).reshape(-1)
        rc = _all_gather(r_local.reshape(-1, g).sum(-1), group, plan.n_shards)
        return fine + _prolong(coarse_rows @ rc, g, rps * k)

    return precond


def _check_precondition(precondition):
    if precondition not in PRECONDITIONERS:
        raise ValueError(f"unknown precondition: {precondition!r}")


def _make_sharded_run(plan, device_mesh, precondition, tol, maxiter):
    """``run(local_s, b_local) -> (x_full, iterations, residual,
    converged)`` of this rank: its halo cells' element matrices ``local_s``
    (T_max, n_loc, n_loc) and its rows ``b_local`` (rps * k,) of the
    permuted padded rhs; ``x_full`` is the whole padded solution, the same
    on every rank."""
    _check_precondition(precondition)
    group, rank, n_shards = _group(device_mesh)
    if maxiter is None:
        maxiter = max(10 * plan.nb_pad * plan.st.block, 100)

    def pdot(u, v):
        d = torch.dot(u, v)
        dist.all_reduce(d, group=group)
        return d

    def run(local_s, b_local):
        tables = _shard_tables(plan, rank, local_s.device)
        v1, v2, diag_local = _scatter_local_values(plan, local_s, tables)
        matvec = _shard_matvec(plan, group, v1, v2, tables)
        if precondition in ("auto", "two_level"):
            precond = _shard_two_level_precond(plan, group, rank, v1, v2, tables)
        else:  # jacobi
            inv_d = 1.0 / torch.where(diag_local != 0, diag_local, torch.ones_like(diag_local))
            precond = lambda r: inv_d * r  # noqa: E731
        x, info = pcg(matvec, b_local, precond=precond, tol=tol, maxiter=maxiter, dot=pdot)
        x_full = _all_gather(x, group, n_shards)
        return x_full, info.iterations, info.residual_norm, info.converged

    return run


def _local_rows(plan, b_pad, rank):
    n_local = plan.rps * plan.st.block
    return b_pad[rank * n_local:(rank + 1) * n_local]


def sharded_bsr_solver(
    basis,
    bilinear_form: Callable,
    linear_form: Optional[Callable] = None,
    device_mesh=None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition: str = "auto",
    max_b: Optional[int] = None,
):
    """Assemble+solve with cells and block rows sharded over the process
    group: the multi-process twin of
    :func:`ops.compiled.compiled_bsr_solver`.

    Every rank calls it with the same basis (on its own device). Each rank
    integrates its halo cells, scatters into its value slice, builds its
    slices of the aggregate-block smoother and the coarse rows, and runs
    row-sharded PCG (see the module docstring). The right-hand side is
    assembled once here; ``precondition`` is ``"auto"``/``"two_level"``
    (the aggregate-block two-level M) or ``"jacobi"``.

    Returns ``solve(b=None) -> (u, (iterations, residual, converged))``
    with an optional replacement rhs ``b`` (n_dofs, 1); every rank gets the
    full ``u``. ``iterations`` is a Python int, the other two 0-dim
    tensors.
    """
    _check_precondition(precondition)
    device_mesh = _default_mesh(device_mesh)
    _, rank, n_shards = _group(device_mesh)
    plan = get_bsr_shard_plan(basis, n_shards, max_b=max_b)
    st = plan.st
    n_pad = plan.nb_pad * st.block
    run = _make_sharded_run(plan, device_mesh, precondition, tol, maxiter)

    from ..ops.compiled import _CellChunkView

    cells = _shard_tables(plan, rank, basis.device).cells
    vgrad_s, dx_s, pts_s = basis.v_grad[cells], basis._dx[cells], basis.integration_points[cells]
    if linear_form is not None:
        b0 = basis.integrate_linear_form(linear_form)
    else:
        b0 = basis.solution_tensor()
    n_dofs = basis.n_dofs

    def solve(b=None):
        view = _CellChunkView(basis.v, vgrad_s, pts_s, dx_s, basis._element)
        local_s = (basis._evaluate_form(bilinear_form, view) * dx_s).sum(-3)
        b_pad = torch.nn.functional.pad(bsr_reduce(st, b0 if b is None else b),
                                        (0, n_pad - st.n_pad))
        x_full, it, res, conv = run(local_s, _local_rows(plan, b_pad, rank))
        u = basis.solution_tensor() + bsr_expand(st, x_full[: st.n_pad], n_dofs)
        return u, (it, res, conv)

    return solve


def solve_pcg_sharded_bsr(
    basis,
    local_matrices,
    vector,
    device_mesh=None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    precondition: str = "two_level",
    return_info: bool = False,
    max_b: Optional[int] = None,
):
    """PCG on precomputed element matrices with block rows sharded.

    Every rank passes the same full ``local_matrices`` and ``vector``; each
    keeps its halo cells' matrices and its rows, and the solve is the core
    of :func:`sharded_bsr_solver`. ``"two_level"`` is the single-process
    aggblock policy (iteration parity), ``"jacobi"`` the sharded point
    diagonal. Returns ``u`` (``(u, PCGInfo)`` with ``return_info``), the
    same on every rank.
    """
    device_mesh = _default_mesh(device_mesh)
    _, rank, n_shards = _group(device_mesh)
    plan = get_bsr_shard_plan(basis, n_shards, max_b=max_b)
    st = plan.st
    run = _make_sharded_run(plan, device_mesh, precondition, tol, maxiter)
    n_loc = int(basis._global_dofs4elements.shape[-1])
    local = local_matrices.reshape(-1, n_loc, n_loc)
    local_s = local[_shard_tables(plan, rank, local.device).cells]
    b_pad = torch.nn.functional.pad(bsr_reduce(st, vector), (0, plan.nb_pad * st.block - st.n_pad))
    x_full, it, res, conv = run(local_s, _local_rows(plan, b_pad, rank))
    u = basis.solution_tensor() + bsr_expand(st, x_full[: st.n_pad], basis.n_dofs)
    return (u, PCGInfo(it, res, conv)) if return_info else u
