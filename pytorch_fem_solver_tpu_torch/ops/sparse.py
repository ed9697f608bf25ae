"""ELL sparse operators: scatter-free SpMV for the PCG loop.

Counterpart of ``pytorch_fem_solver_tpu/ops/sparse.py``. The reduced
(interior-DOF) operator is stored as ELLPACK rows plus an optional COO tail:

    y[i] = sum_k vals[i, k] * x[cols[i, k]]        k < K (max row degree ~ 8)

one gather and a multiply-reduce per row. The slot map from unassembled
element-matrix entries to (row, k) positions is computed once on the host
with NumPy, byte-identical to the JAX package; assembly is then a padded
gather and a small-axis sum. The tables move to the device once, when the
structure is built, and every solve after that reads them there.

The JAX package runs this module with XLA (no Pallas kernel), so the device
side here is plain PyTorch: the gather is ``x[cols]`` and the spill tail's
``segment_sum`` is an ``index_add_``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config


class ELLStructure(NamedTuple):
    """Static (host-built) ELL layout for a reduced FEM operator.

    Optionally *hybrid*: rows with degree > K spill their excess entries
    into a COO tail (``spill_*``); the diagonal always stays in the ELL part.
    Device tables are int32 (``pad_mask`` in the structure's float dtype),
    byte-identical to the JAX package's; ``slots`` and ``keep`` stay on the
    host. ``cols_index`` and ``spill_cols_index`` are int64 copies of the
    column tables that the SpMV gathers with: PyTorch's gather widens an
    int32 index to int64 in a copy kernel on every call.
    """

    cols: torch.Tensor  # (n_inner, K) reduced column ids (padding -> row 0)
    pad_mask: torch.Tensor  # (n_inner, K) 1.0 where a real entry lives
    slots: np.ndarray  # host-side: target slot (row * K + k) per kept entry
    keep: np.ndarray  # host-side: indices into the flat element entries
    gather: torch.Tensor  # (n_slots, D) flat-entry ids per slot (pad = n_entries)
    spill_rows: torch.Tensor  # (S,) reduced row ids of spilled pairs
    spill_cols: torch.Tensor  # (S,) reduced col ids of spilled pairs
    spill_gather: torch.Tensor  # (S, D2) flat-entry ids per spilled pair
    n_inner: int
    n_entries: int  # total flat element-entry count (T * n_loc^2)
    cols_index: torch.Tensor  # (n_inner, K) ``cols`` as int64
    spill_cols_index: torch.Tensor  # (S,) ``spill_cols`` as int64


def _host(array) -> np.ndarray:
    if isinstance(array, torch.Tensor):
        return array.cpu().numpy()
    return np.asarray(array)


def _device_of(array, device) -> torch.device:
    """An explicit ``device``, else that of a tensor argument, else the
    card (``config.resolve_device``)."""
    if device is None and isinstance(array, torch.Tensor):
        return array.device
    return config.resolve_device(device)


def invert_scatter_map(target_ids, n_targets: int, source_positions, pad: int):
    """Turn a scatter (entry -> target) into a gather table (target -> entries).

    Returns an (n_targets, D) int64 host table of source positions, padded
    with ``pad``: a scatter-add with duplicate indices becomes a gather and a
    small-axis sum.
    """
    from ..native import radix_argsort

    target_ids = np.asarray(target_ids)
    source_positions = np.asarray(source_positions)
    order = radix_argsort(target_ids)
    if order is None:
        order = np.argsort(target_ids, kind="stable")
    sorted_t = target_ids[order]
    counts = np.bincount(sorted_t, minlength=n_targets)
    D = max(1, int(counts.max(initial=0)))
    table = np.full((n_targets, D), pad, dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])
    pos = np.arange(sorted_t.size) - starts[sorted_t]
    table[sorted_t, pos] = source_positions[order]
    return table


def build_ell_structure(
    dofs,
    n_dofs: int,
    inner,
    max_k: int | None = None,
    *,
    device=None,
    dtype: torch.dtype | None = None,
) -> ELLStructure:
    """Host-side construction of the reduced (hybrid) ELL layout.

    Args:
      dofs: (T, n_loc) global DOF ids per cell (tensor or NumPy).
      n_dofs: total global DOF count.
      inner: (n_inner,) interior DOF ids (Dirichlet rows/cols eliminated).
      max_k: cap on entries-per-row in the ELL part; rows with more entries
        spill the excess into the COO tail. None = no spill (pure ELL).
      device: where the tables live (default: that of ``dofs`` if it is a
        tensor, else the card).
      dtype: float dtype of ``pad_mask`` (default ``config.default_dtype()``).
    """
    device = _device_of(dofs, device)
    dofs = _host(dofs)
    dofs = dofs.reshape(-1, dofs.shape[-1])
    inner = _host(inner)
    n_loc = dofs.shape[1]

    reduced_id = np.full(n_dofs, -1, dtype=np.int64)
    reduced_id[inner] = np.arange(inner.size)

    rows = reduced_id[np.repeat(dofs, n_loc, axis=1).reshape(-1)]
    cols = reduced_id[np.tile(dofs, (1, n_loc)).reshape(-1)]
    keep_all = np.nonzero((rows >= 0) & (cols >= 0))[0]
    rows_k = rows[keep_all]
    cols_k = cols[keep_all]

    # unique (row, col) pairs -> one slot each
    pair_key = rows_k * inner.size + cols_k
    uniq_keys, entry_pair = np.unique(pair_key, return_inverse=True)
    uniq_rows = uniq_keys // inner.size
    uniq_cols = uniq_keys % inner.size

    counts = np.bincount(uniq_rows, minlength=inner.size)
    K_full = int(counts.max()) if counts.size else 1
    K = K_full if max_k is None else min(K_full, int(max_k))

    # position of each unique pair within its row (keys sorted -> pairs of
    # one row are consecutive), with each row's diagonal swapped into
    # position 0 so it never spills and the Jacobi diagonal stays in ELL
    row_starts = np.concatenate([[0], np.cumsum(counts)])
    k_of_pair = np.arange(uniq_keys.size) - row_starts[uniq_rows]
    diag_mask = uniq_rows == uniq_cols
    diag_pos = np.zeros(inner.size, dtype=np.int64)
    diag_pos[uniq_rows[diag_mask]] = k_of_pair[diag_mask]
    k_of_pair = np.where(
        diag_mask,
        0,
        np.where(k_of_pair == 0, diag_pos[uniq_rows], k_of_pair),
    )

    in_ell = k_of_pair < K
    ell_pairs = np.nonzero(in_ell)[0]
    spill_pairs = np.nonzero(~in_ell)[0]

    ell_cols = np.zeros((inner.size, K), dtype=np.int64)
    pad = np.zeros((inner.size, K), dtype=np.float64)
    ell_cols[uniq_rows[ell_pairs], k_of_pair[ell_pairs]] = uniq_cols[ell_pairs]
    pad[uniq_rows[ell_pairs], k_of_pair[ell_pairs]] = 1.0

    # slot id per unique pair: ELL pairs -> row*K + k; spilled pairs ->
    # n_inner*K + spill_index
    pair_slot = np.full(uniq_keys.size, -1, dtype=np.int64)
    pair_slot[ell_pairs] = uniq_rows[ell_pairs] * K + k_of_pair[ell_pairs]
    pair_slot[spill_pairs] = inner.size * K + np.arange(spill_pairs.size)

    slots = pair_slot[entry_pair]
    n_slots = inner.size * K + spill_pairs.size

    gather_full = invert_scatter_map(slots, n_slots, keep_all, pad=int(rows.size))
    gather = gather_full[: inner.size * K]
    spill_gather = gather_full[inner.size * K :]

    def index(a):
        return torch.as_tensor(
            np.asarray(a).astype(np.int32), dtype=config.index_dtype(), device=device
        )

    spill_cols = uniq_cols[spill_pairs]
    return ELLStructure(
        cols=index(ell_cols),
        pad_mask=torch.as_tensor(
            pad, dtype=dtype or config.default_dtype(), device=device
        ),
        slots=np.asarray(slots, dtype=np.int64),
        keep=np.asarray(keep_all, dtype=np.int64),
        gather=index(gather),
        spill_rows=index(uniq_rows[spill_pairs]),
        spill_cols=index(spill_cols),
        spill_gather=index(spill_gather),
        n_inner=int(inner.size),
        n_entries=int(rows.size),
        cols_index=torch.as_tensor(ell_cols, device=device),
        spill_cols_index=torch.as_tensor(spill_cols, dtype=torch.int64, device=device),
    )


def _padded_flat(local: torch.Tensor) -> torch.Tensor:
    """The flat entries with one zero appended (the padding target)."""
    flat = local.reshape(-1)
    return torch.cat([flat, flat.new_zeros(1)])


def ell_values_from_local(structure: ELLStructure, local_matrices):
    """Assemble element matrices into the fixed slots — gather-only.

    Returns ``(ell_values (n_inner, K), spill_values (S,))``.
    """
    flat = _padded_flat(local_matrices)
    K = structure.cols.shape[1]
    ell = flat[structure.gather].sum(dim=-1).reshape(structure.n_inner, K)
    if structure.spill_rows.shape[0]:
        spill = flat[structure.spill_gather].sum(dim=-1)
    else:
        spill = flat.new_zeros(0)
    return ell, spill


def ell_matvec(structure: ELLStructure, values, x):
    """y = A_reduced @ x via gather + multiply-reduce (+ the COO tail)."""
    ell, spill = values
    y = (ell * x[structure.cols_index]).sum(dim=-1)
    if structure.spill_rows.shape[0]:
        y = y.index_add(0, structure.spill_rows, spill * x[structure.spill_cols_index])
    return y


def ell_diagonal(structure: ELLStructure, values):
    """Diagonal of the reduced operator (always in the ELL part)."""
    ell, _ = values
    row_ids = torch.arange(
        structure.n_inner, dtype=structure.cols.dtype, device=ell.device
    )[:, None]
    on_diag = (structure.cols == row_ids) & (structure.pad_mask > 0)
    return torch.where(on_diag, ell, torch.zeros_like(ell)).sum(dim=-1)


class LoadStructure(NamedTuple):
    """Gather table for scatter-free load-vector assembly."""

    gather: torch.Tensor  # (n_dofs, D) flat entry ids, pad = n_entries
    n_entries: int


def build_load_structure(dofs, n_dofs: int, *, device=None) -> LoadStructure:
    """Host-built inverse of the linear-form scatter (dof -> entries)."""
    device = _device_of(dofs, device)
    flat_dofs = _host(dofs).reshape(-1)
    table = invert_scatter_map(
        flat_dofs, n_dofs, np.arange(flat_dofs.size), pad=int(flat_dofs.size)
    )
    return LoadStructure(
        gather=torch.as_tensor(
            table.astype(np.int32), dtype=config.index_dtype(), device=device
        ),
        n_entries=int(flat_dofs.size),
    )


def load_from_local(structure: LoadStructure, local_vectors) -> torch.Tensor:
    """Assemble element load vectors (..., T, n_loc, 1) -> (n_dofs, 1)."""
    return _padded_flat(local_vectors)[structure.gather].sum(dim=-1)[:, None]


def get_ell_structure(basis, max_k: int | None = None) -> ELLStructure:
    """Cached-per-basis ELL layout, keyed by ``max_k``, on the basis's
    device with its float dtype."""
    cache = getattr(basis, "_ell_structures", None)
    if cache is None:
        cache = {}
        basis._ell_structures = cache
    structure = cache.get(max_k)
    if structure is None:
        structure = build_ell_structure(
            basis._global_dofs4elements,
            basis.n_dofs,
            basis._basis_parameters["inner_dofs"],
            max_k=max_k,
            device=basis.device,
            dtype=basis.dtype,
        )
        cache[max_k] = structure
    return structure


def reduced_ell_operator(basis, local_matrices):
    """ELL ``(matvec, diagonal)`` for a basis's reduced bilinear operator;
    the structure is cached on the basis."""
    structure = get_ell_structure(basis)
    values = ell_values_from_local(structure, local_matrices)

    def matvec(x):
        return ell_matvec(structure, values, x)

    return matvec, ell_diagonal(structure, values)
