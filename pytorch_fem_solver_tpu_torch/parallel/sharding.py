"""Multi-process scaling: cell-sharded assembly and PCG over a process group.

Counterpart of ``pytorch_fem_solver_tpu/parallel/sharding.py``. The JAX
package runs SPMD through ``shard_map`` on a device mesh; here every rank of
a ``torch.distributed`` process group calls the same entry point on its own
slice and the collectives are explicit. The cell axis is padded to a whole
number of chunks exactly as the JAX package pads it (zero element matrices,
or geometry that repeats the last real cell with zero weight), and rank r
keeps chunk r:

    x (replicated, n_dofs)  --gather-->  x_loc (this rank's cells)
    y_loc = A_loc @ x_loc                (tiny batched matmuls)
    y_partial = index_add(y_loc)         (this rank's partial DOF vector)
    y = all_reduce(y_partial, SUM)       (the JAX ``psum``)

``make_device_mesh`` wraps the caller's process group in a 1-D
``DeviceMesh`` (dimension ``"cells"``); it starts no group itself. A rank's
device is ``cuda:<local rank>`` under NCCL and the CPU under gloo
(``mesh_device``).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from ..ops.operators import local_matvec, operator_diagonal
from ..ops.solvers import pcg

__all__ = [
    "CELL_AXIS",
    "make_device_mesh",
    "mesh_device",
    "shard_basis_cells",
    "solve_pcg_sharded",
    "solve_pcg_sharded_ell",
]

CELL_AXIS = "cells"

#: per-basis caches of solver layouts (``ops``); they describe the whole
#: mesh, so a rank's shard copy of a basis must not inherit them
_LAYOUT_CACHES = (
    "_bsr_structures", "_ell_structures", "_chunk_tables", "_agg_block_tables",
    "_three_level_structures", "_affine_two_level_structures", "_two_level_structure",
)


def make_device_mesh(n_devices: Optional[int] = None, axis_name: str = CELL_AXIS):
    """1-D ``DeviceMesh`` over the ranks of the initialised default process
    group, its one dimension named ``axis_name``: ``"cuda"`` when the
    group's backend is NCCL, else ``"cpu"`` (gloo). ``n_devices`` must be
    None or the world size. Raises unless a default group is initialised
    (``torch.distributed.init_process_group``): none is started here."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_device_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group first"
        )
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(
            f"n_devices={n_devices} must equal the process group's world size {world}"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis_name,))


def mesh_device(device_mesh) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` on a CUDA mesh (the
    ``LOCAL_RANK`` of the launcher, else the rank modulo the visible cards),
    the CPU otherwise."""
    if device_mesh.device_type != "cuda":
        return torch.device("cpu")
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", index)


def _group(device_mesh):
    """(process group, this rank's index in the mesh, mesh size)."""
    return device_mesh.get_group(), device_mesh.get_local_rank(), device_mesh.size()


def _default_mesh(device_mesh):
    return make_device_mesh() if device_mesh is None else device_mesh


def _pad_cells(local_matrices, dofs, n_shards: int):
    """Pad the cell axis to a multiple of the mesh size with zero matrices.

    Zero local matrices scatter nothing, so padding is exact (their DOF ids
    point at 0, which receives only zeros).
    """
    pad = (-local_matrices.shape[0]) % n_shards
    if pad:
        local_matrices = torch.cat(
            [local_matrices, local_matrices.new_zeros((pad,) + local_matrices.shape[1:])]
        )
        dofs = torch.cat([dofs, dofs.new_zeros((pad,) + dofs.shape[1:])])
    return local_matrices, dofs


def _solution(x_reduced, info, basis, inner, return_info):
    """``u`` (``(u, PCGInfo)`` with ``return_info``) from the reduced
    solution, as the JAX ``solution.at[..., inner, 0].add(x)``."""
    u = basis.solution_tensor()
    u = u.index_add(u.dim() - 2, inner, x_reduced[..., None])
    return (u, info) if return_info else u


def solve_pcg_sharded(
    basis,
    local_matrices,
    vector,
    device_mesh=None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    return_info: bool = False,
):
    """Matrix-free Jacobi-PCG with the cells sharded over the process group.

    Every rank passes the same full ``local_matrices`` and ``vector`` (as
    the JAX entry point takes them) and keeps its chunk of the padded
    cells; each matvec does one ``all_reduce`` of the partial DOF vector,
    and the iterate, the dots and the result are replicated. Returns ``u``
    (``(u, PCGInfo)`` with ``return_info``), the same on every rank.
    """
    group, rank, n_shards = _group(_default_mesh(device_mesh))
    n_loc = basis._global_dofs4elements.shape[-1]
    dofs = basis._global_dofs4elements.reshape(-1, n_loc).long()
    local = local_matrices.reshape(-1, n_loc, n_loc)
    n = basis.n_dofs
    inner = basis._basis_parameters["inner_dofs"].long()

    local, dofs = _pad_cells(local, dofs, n_shards)
    chunk = local.shape[0] // n_shards
    local_chunk = local[rank * chunk:(rank + 1) * chunk]
    dofs_chunk = dofs[rank * chunk:(rank + 1) * chunk]

    diag = operator_diagonal(local, dofs, n)[inner]
    b_reduced = basis.reduce(vector)[..., 0]
    if maxiter is None:
        maxiter = max(10 * int(b_reduced.shape[-1]), 100)

    def matvec(x_reduced):
        x_full = x_reduced.new_zeros(n).index_copy(0, inner, x_reduced)
        y = local_matvec(local_chunk, dofs_chunk, n, x_full)
        dist.all_reduce(y, group=group)
        return y[inner]

    x, info = pcg(matvec, b_reduced, precond_diag=diag, tol=tol, maxiter=maxiter)
    return _solution(x, info, basis, inner, return_info)


def solve_pcg_sharded_ell(
    basis,
    local_matrices,
    vector,
    device_mesh=None,
    tol: float = 1e-10,
    maxiter: Optional[int] = None,
    max_k: int = 8,
    return_info: bool = False,
):
    """Jacobi-PCG with the hybrid-ELL operator row-sharded over the group.

    Each rank owns a block of reduced rows (ELL values and columns, padded
    to a whole number of blocks), the iterate is replicated, and each
    matvec gathers the row-block products with one tiled
    ``all_gather_into_tensor``; the small COO spill tail is evaluated on
    every rank (no second collective), as in the JAX package.
    """
    from ..ops.sparse import ell_diagonal, ell_values_from_local, get_ell_structure

    group, rank, n_shards = _group(_default_mesh(device_mesh))
    structure = get_ell_structure(basis, max_k=max_k)
    ell, spill = ell_values_from_local(structure, local_matrices)
    diag = ell_diagonal(structure, (ell, spill))
    b_reduced = basis.reduce(vector)[..., 0]

    n = structure.n_inner
    pad = (-n) % n_shards
    n_pad = n + pad
    rows = n_pad // n_shards
    K = structure.cols.shape[1]
    ell_p = torch.cat([ell, ell.new_zeros((pad, K))])
    cols_p = torch.cat([structure.cols_index, structure.cols_index.new_zeros((pad, K))])
    diag_p = torch.cat([diag, diag.new_ones(pad)])
    b_p = torch.cat([b_reduced, b_reduced.new_zeros(pad)])
    if maxiter is None:
        maxiter = max(10 * n, 100)

    lo, hi = rank * rows, (rank + 1) * rows
    ell_chunk, cols_chunk = ell_p[lo:hi], cols_p[lo:hi]
    has_spill = bool(structure.spill_rows.shape[0])
    spill_rows = structure.spill_rows.long()

    def matvec(x):
        y_local = (ell_chunk * x[cols_chunk]).sum(dim=-1)
        if has_spill:
            y_spill = x.new_zeros(n_pad).index_add(
                0, spill_rows, spill * x[structure.spill_cols_index]
            )
            y_local = y_local + y_spill[lo:hi]
        y = x.new_empty(n_pad)
        dist.all_gather_into_tensor(y, y_local, group=group)
        return y

    x, info = pcg(matvec, b_p, precond_diag=diag_p, tol=tol, maxiter=maxiter)
    inner = basis._basis_parameters["inner_dofs"].long()
    return _solution(x[:n], info, basis, inner, return_info)


class _ShardedCells:
    """Mixin of a rank's shard copy of a basis (``shard_basis_cells``):
    assembled vectors and matrices are summed over the group, per-cell
    functionals gathered along the cell axis. The collectives are those of
    ``torch.distributed.nn.functional``, so autograd differentiates through
    them."""

    _cell_group = None

    def _assemble_linear_from_local(self, local):
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(super()._assemble_linear_from_local(local), group=self._cell_group)

    def _assemble_bilinear_from_local(self, local):
        from torch.distributed.nn.functional import all_reduce

        return all_reduce(super()._assemble_bilinear_from_local(local), group=self._cell_group)

    def integrate_functional(self, function, *args, **kwargs):
        from torch.distributed.nn.functional import all_gather

        part = super().integrate_functional(function, *args, **kwargs)
        return torch.cat(all_gather(part.contiguous(), group=self._cell_group), dim=-2)


def shard_basis_cells(basis, device_mesh=None):
    """This rank's shard of a basis's per-cell quadrature arrays.

    A shallow copy whose ``v_grad``, ``integration_points`` and ``_dx``
    (their fracture-batched variants along the per-batch cell axis) are
    this rank's chunk of the cell axis, padded as the JAX package pads it:
    padded cells repeat the last real cell's geometry (finite coordinates
    for user closures), carry zero weight and scatter into DOF 0, so every
    integral is exact. The DOF table of a batched DFN basis is padded per
    fracture. On the copy, assembled vectors and matrices sum over the
    group and ``integrate_functional`` returns the whole padded cell axis
    (trailing zero rows for the padding), so losses built on it are
    replicated; ``integrate_*_local`` return this rank's cells. A loss
    differentiated on every rank gives each rank the world size times its
    cells' share of the gradient (the collectives' backward sums over the
    group), so averaging the parameter gradients over the group, as
    ``DistributedDataParallel`` does, yields the full gradient. The
    original basis is untouched, and the copy inherits none of its solver
    layout caches.
    """
    group, rank, n_shards = _group(_default_mesh(device_mesh))
    n_cells = int(basis.integration_points.shape[-4])
    batched = basis.integration_points.dim() > 4
    pad = (-n_cells) % n_shards
    chunk = (n_cells + pad) // n_shards

    def cell_axis_of(x):
        if batched and x.dim() >= 2 and x.shape[1] in (n_cells, n_cells + pad):
            return 1
        return 0

    def shard(x, mode):
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            return x
        ca = cell_axis_of(x)
        if x.shape[ca] != n_cells:
            return x
        if pad:
            if mode == "zero":
                shape = list(x.shape)
                shape[ca] = pad
                tail = x.new_zeros(shape)
            else:  # repeat the last real cell: finite geometry for closures
                tail = x.narrow(ca, n_cells - 1, 1).expand(
                    *x.shape[:ca], pad, *x.shape[ca + 1:]
                )
            x = torch.cat([x, tail], dim=ca)
        return x.narrow(ca, rank * chunk, chunk)

    cls = type(f"Sharded{type(basis).__name__}", (_ShardedCells, type(basis)), {})
    out = cls.__new__(cls)
    out.__dict__.update(
        {k: v for k, v in basis.__dict__.items() if k not in _LAYOUT_CACHES}
    )
    out._cell_group = group
    out.v_grad = shard(basis.v_grad, "edge")
    out.integration_points = shard(basis.integration_points, "edge")
    out._dx = shard(basis._dx, "zero")

    dofs = basis._global_dofs4elements
    if batched and dofs.dim() == 2 and dofs.shape[0] != n_cells:
        # flat (B*T, n_loc) table of a batched basis (the DFN glue): local
        # values flatten as (B, chunk, n_loc), so each fracture is padded
        # and sliced on its own
        n_batch = dofs.shape[0] // n_cells
        d3 = dofs.reshape(n_batch, n_cells, -1)
        d3 = torch.cat([d3, d3.new_zeros((n_batch, pad, d3.shape[-1]))], dim=1)
        dofs_s = d3[:, rank * chunk:(rank + 1) * chunk].reshape(n_batch * chunk, -1)
    else:
        zshape = list(dofs.shape)
        zshape[-2] = pad
        dofs_p = torch.cat([dofs, dofs.new_zeros(zshape)], dim=-2)
        dofs_s = dofs_p.narrow(-2, rank * chunk, chunk)
    out._global_dofs4elements = dofs_s.contiguous()
    batch_size = dofs_s.shape[0] if dofs_s.dim() == 3 else None
    rebuilt = out._build_assembly_parameters(
        basis.n_dofs, out._global_dofs4elements, basis._nodes4boundary_dofs, batch_size
    )
    out._basis_parameters = {**basis._basis_parameters, **rebuilt}
    return out
