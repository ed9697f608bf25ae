"""Batch of B triangular meshes with identical topology sizes.

Counterpart of ``pytorch_fem_solver_tpu/mesh/meshes_tri.py``: each mesh's
topology is built on the host once and the derived NumPy arrays are
stacked, so every downstream computation runs over a leading batch axis.
All meshes of a batch must have equal vertex, cell and edge counts.
``apply_mask`` selects the same number of entries from every batch entry.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .. import config
from .mesh_tri import MeshTri, _freeze


def batched_take(array: torch.Tensor, idx) -> torch.Tensor:
    """``out[b, ...] = array[b][idx[b, ...]]`` (the JAX package's
    ``vmap(lambda arr, i: arr[i])``)."""
    idx = torch.as_tensor(idx, device=array.device).long()
    batch = torch.arange(idx.shape[0], device=idx.device)
    return array[batch.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]


def _stack_groups(groups: list[dict]) -> dict:
    """Stack the leaves of equally shaped nested dicts along a new axis 0."""
    first = groups[0]
    if isinstance(first, dict):
        return {k: _stack_groups([g[k] for g in groups]) for k in first}
    return np.stack(groups, axis=0)


class MeshesTri(MeshTri):
    """B stacked triangle meshes; every array gains a leading batch axis.

    ``device`` defaults to the card (``config.resolve_device``); ``dtype``
    to ``config.default_dtype()``.
    """

    def __init__(
        self,
        triangulations: Sequence[dict[str, Any]] | None = None,
        *,
        device=None,
        dtype: torch.dtype | None = None,
        _groups=None,
    ):
        if _groups is not None:
            self._t = _groups
            return
        if not triangulations:
            raise ValueError("MeshesTri requires a non-empty list of triangulations")
        groups = [MeshTri._build_groups(self, dict(t)) for t in triangulations]
        self._t = _freeze(
            _stack_groups(groups),
            config.resolve_device(device),
            dtype or config.default_dtype(),
        )

    def batch_size(self):
        return (int(self["vertices", "coordinates"].shape[0]),)

    @property
    def n_meshes(self) -> int:
        return self.batch_size()[0]

    @staticmethod
    def compute_coordinates_4_cells(coordinates_4_vertices, vertices_4_cells):
        """Batched gather: out[b, c, i] = coords[b, cells[b, c, i]]."""
        return batched_take(coordinates_4_vertices, vertices_4_cells)

    @staticmethod
    def apply_mask(tensor, mask):
        """Select entries along axis 1 of every batch entry: ``mask`` either
        integer indices ``(B, k)`` (a plain batched gather) or a boolean
        ``(B, N)`` mask that selects the same count in every entry (the
        selected entries in their order). A list or tuple passes its first
        element, as in the JAX package.

        The boolean branch is host-bound: the selected count is read back
        from the device before the gather.
        """
        if isinstance(mask, (list, tuple)):
            mask = mask[0]
        mask = torch.as_tensor(mask, device=tensor.device)
        if mask.dtype == torch.bool:
            count = int(mask[0].sum())
            idx = torch.argsort((~mask).to(torch.uint8), dim=-1, stable=True)[..., :count]
            return batched_take(tensor, idx)
        return batched_take(tensor, mask)
