"""Vertex-centered criss-cross patches (batched local meshes).

Counterpart of ``pytorch_fem_solver_tpu/mesh/patches.py``: B square
patches, each split into 4 triangles around its center, the batched local
test spaces of patch RVPINNs. Every patch shares one template topology (5
vertices, 4 cells, 8 edges), so the topology is built once on the host from
the unit template and only the geometry (coordinates, lengths) is broadcast
over the batch; the finished tables move to the device once.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import config
from .mesh_tri import MeshTri, _freeze
from .meshes_tri import MeshesTri

#: corner sign pattern (counter-clockwise) plus center
SIGNS_4_VERTICES = np.array(
    [[-1.0, -1.0], [1.0, -1.0], [1.0, 1.0], [-1.0, 1.0], [0.0, 0.0]]
)
#: the 4 triangles of a patch
VERTICES_4_CELLS_4_PATCH = np.array(
    [[0, 1, 4], [1, 2, 4], [2, 3, 4], [3, 0, 4]], dtype=np.int64
)
#: corner DOFs are boundary, the center is interior
MARKERS_4_VERTICES = np.array([[1], [1], [1], [1], [0]], dtype=np.int64)


def _host64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float64)


class Patches(MeshesTri):
    """B criss-cross square patches around given centers with given radii.

    ``device`` defaults to the card (``config.resolve_device``); ``dtype``
    to ``config.default_dtype()``.
    """

    def __init__(
        self,
        centers,
        radius,
        *,
        device=None,
        dtype: torch.dtype | None = None,
        _groups=None,
    ):
        if _groups is not None:
            self._t = _groups
            return

        centers = _host64(centers).reshape(-1, 2)
        radius = _host64(radius).reshape(-1, 1)
        if centers.shape[0] != radius.shape[0]:
            raise ValueError("centers and radius must have the same batch size")

        # template topology on the unit patch (center 0, radius 1)
        t = MeshTri._build_groups(
            self,
            {
                "vertices": SIGNS_4_VERTICES,
                "triangles": VERTICES_4_CELLS_4_PATCH,
                "vertex_markers": MARKERS_4_VERTICES,
            },
        )

        B = centers.shape[0]
        c = centers[:, None, :]  # (B, 1, 2)
        r = radius[:, None, :]  # (B, 1, 1)

        def tile(x):
            return np.broadcast_to(x, (B,) + x.shape).copy()

        groups = {
            "vertices": {
                "coordinates": c + r * t["vertices"]["coordinates"],
                "markers": tile(t["vertices"]["markers"]),
            },
            "cells": {
                "vertices": tile(t["cells"]["vertices"]),
                "coordinates": c[:, None] + r[:, None] * t["cells"]["coordinates"],
                "length": radius[:, :, None, None, None] * t["cells"]["length"][None],
            },
            "edges": {
                "vertices": tile(t["edges"]["vertices"]),
                "markers": tile(t["edges"]["markers"]),
            },
            "interior_edges": {
                "vertices": tile(t["interior_edges"]["vertices"]),
                "cells": tile(t["interior_edges"]["cells"]),
                "coordinates": c[:, None] + r[:, None] * t["interior_edges"]["coordinates"],
                "length": radius[:, :, None, None] * t["interior_edges"]["length"][None],
                "normals": tile(t["interior_edges"]["normals"]),
            },
            "boundary_edges": {
                "vertices": tile(t["boundary_edges"]["vertices"]),
                "cells": tile(t["boundary_edges"]["cells"]),
                "coordinates": c[:, None] + r[:, None] * t["boundary_edges"]["coordinates"],
            },
            "patches": {"centers": centers, "radius": radius},
        }
        self._t = _freeze(
            groups, config.resolve_device(device), dtype or config.default_dtype()
        )

    @property
    def centers(self) -> torch.Tensor:
        return self._t["patches"]["centers"]

    @property
    def radius(self) -> torch.Tensor:
        return self._t["patches"]["radius"]

    @property
    def signs_4_vertices(self) -> torch.Tensor:
        return torch.tensor(SIGNS_4_VERTICES, dtype=self.dtype, device=self.device)

    @property
    def vertices_4_cells_4_patch(self) -> torch.Tensor:
        return torch.tensor(
            VERTICES_4_CELLS_4_PATCH, dtype=config.index_dtype(), device=self.device
        )

    @property
    def markers_4_vertices(self) -> torch.Tensor:
        return torch.tensor(
            MARKERS_4_VERTICES, dtype=config.index_dtype(), device=self.device
        )

    # -- refinement -----------------------------------------------------------

    def refine_patches(self, refine_idx, maintain_old_patches: bool = False):
        """Split marked patches into 4 axis-aligned children + 1 rotated patch.

        Returns ``(centers, radius, coordinates)`` of the refined patch set
        (on this mesh's device, in its dtype), from which a new ``Patches``
        is built: the kept patches, then the children of each marked patch,
        then the rotated patches, which cover the center regions so that the
        children overlap-cover their parent. Host NumPy in float64.
        """
        if isinstance(refine_idx, torch.Tensor):
            refine_idx = refine_idx.cpu().numpy()
        refine_idx = np.asarray(refine_idx).reshape(-1).astype(bool)
        centers = _host64(self.centers)
        radius = _host64(self.radius)

        new_r = 0.5 * radius[refine_idx]  # (K, 1)
        corner_signs = SIGNS_4_VERTICES[:4]
        # child centers at the parent's quadrant midpoints
        new_centers = (
            centers[refine_idx][:, None, :] + corner_signs[None] * new_r[:, None]
        )  # (K, 4, 2)

        angle = math.pi / 4.0
        rot = np.array(
            [[math.cos(angle), -math.sin(angle)], [math.sin(angle), math.cos(angle)]]
        )
        rotated_radius = 2.0 * new_r / math.sqrt(2.0)
        rotated_centers = centers[refine_idx]

        if maintain_old_patches:
            keep_centers, keep_radius = centers, radius
        else:
            keep_centers, keep_radius = centers[~refine_idx], radius[~refine_idx]

        refined_centers = np.concatenate(
            [keep_centers, new_centers.reshape(-1, 2), rotated_centers], axis=0
        )
        refined_radius = np.concatenate(
            [keep_radius, np.repeat(new_r, 4, axis=0), rotated_radius], axis=0
        )

        # explicit vertex coordinates (children axis-aligned, last K rotated)
        child_coords = (
            new_centers.reshape(-1, 2)[:, None, :]
            + SIGNS_4_VERTICES[None] * np.repeat(new_r, 4, axis=0)[:, None]
        )
        rotated_signs = SIGNS_4_VERTICES @ rot.T
        rotated_coords = (
            rotated_centers[:, None, :] + rotated_signs[None] * rotated_radius[:, None]
        )
        keep_coords = (
            keep_centers[:, None, :] + SIGNS_4_VERTICES[None] * keep_radius[:, None]
        )
        refined_coords = np.concatenate(
            [keep_coords, child_coords, rotated_coords], axis=0
        )

        def out(x):
            return torch.tensor(x, dtype=self.dtype, device=self.device)

        return out(refined_centers), out(refined_radius), out(refined_coords)

    def uniform_refine(self, nb_refinements: int = 1):
        """Refine every patch ``nb_refinements`` times, compounding: each
        pass refines the patch set the previous pass made (B -> 5B per
        pass). Returns ``(centers, radius, vertex coordinates)``."""
        patches = self
        for _ in range(nb_refinements):
            mask = np.ones(patches.batch_size()[0], dtype=bool)
            centers, radius, _ = patches.refine_patches(mask)
            patches = Patches(centers, radius, device=self.device, dtype=self.dtype)
        return patches.centers, patches.radius, patches["vertices", "coordinates"]
