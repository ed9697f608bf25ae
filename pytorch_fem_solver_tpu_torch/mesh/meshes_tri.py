"""Batch of B triangular meshes with identical topology sizes.

Counterpart of ``pytorch_fem_solver_tpu/mesh/meshes_tri.py``: each mesh's
topology is built on the host once and the derived NumPy arrays are
stacked, so every downstream computation runs over a leading batch axis.
All meshes of a batch must have equal vertex, cell and edge counts.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from .. import config
from .mesh_tri import MeshTri, _freeze


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
        idx = vertices_4_cells.long()
        batch = torch.arange(idx.shape[0], device=idx.device)
        return coordinates_4_vertices[batch.reshape((-1,) + (1,) * (idx.dim() - 1)), idx]
