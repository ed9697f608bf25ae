"""Discrete fracture networks: B planar 2D meshes embedded affinely in 3D.

Counterpart of ``pytorch_fem_solver_tpu/mesh/fractures_tri.py``: a
per-fracture affine map fit from 3 corner correspondences, the 3D lifts of
vertices, cells and interior edges, the lifted interior-edge normals, the
area scale ||j1 x j2|| and the tangential pseudo-inverse. The fit runs in
the mesh's dtype on its device; the collinear-anchor check runs on the host.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .meshes_tri import MeshesTri


class FracturesTri(MeshesTri):
    """Batch of fracture meshes with their 2D -> 3D affine embeddings."""

    def __init__(
        self,
        triangulations: Optional[Sequence[dict]] = None,
        fractures_3d_data=None,
        anchor_vertices_2d=None,
        *,
        device=None,
        dtype: torch.dtype | None = None,
        _groups=None,
    ):
        if _groups is not None:
            self._t = _groups
            return
        super().__init__(triangulations, device=device, dtype=dtype)

        self._compute_fracture_map(
            self._as_mesh_tensor(fractures_3d_data), anchor_vertices_2d
        )

        jac = self["jacobian_fracture_map"]  # (B, 3, 2)
        trans = self["translation_vector"]  # (B, 3, 1)

        self["vertices", "coordinates_3d"] = (
            jac @ self["vertices", "coordinates"].mT + trans
        ).mT
        self["cells", "coordinates_3d"] = self.compute_coordinates_4_cells(
            self["vertices", "coordinates_3d"], self["cells", "vertices"]
        )
        self["interior_edges", "coordinates_3d"] = self.compute_coordinates_4_cells(
            self["vertices", "coordinates_3d"], self["interior_edges", "vertices"]
        )

        # lift normals with the pseudo-inverse transpose: in-plane and
        # perpendicular to the lifted edge for any affine chart
        normals = self["interior_edges", "normals"]  # (B, Ei, 1, 2)
        inv_jac = self["inv_jacobian_fracture_map"]  # (B, 2, 3)
        lifted = normals @ inv_jac[:, None]
        self["interior_edges", "normals_3d"] = lifted / torch.linalg.norm(
            lifted, dim=-1, keepdim=True
        )

    def _as_mesh_tensor(self, array) -> torch.Tensor:
        return torch.as_tensor(np.asarray(array), dtype=self.dtype, device=self.device)

    def _compute_fracture_map(self, fractures_3d_data, anchor_vertices_2d=None):
        """Fit x_3d = J @ x_2d + t from 3 corner pairs per fracture.

        ``fractures_3d_data`` (B, >=3, 3): 3D images of the first three mesh
        vertices (or of ``anchor_vertices_2d`` when given).
        """
        if anchor_vertices_2d is None:
            vertices_2d = self["vertices", "coordinates"][:, :3, :]
        else:
            vertices_2d = self._as_mesh_tensor(anchor_vertices_2d)[:, :3, :]
        vertices_3d = fractures_3d_data[:, :3, :]

        # collinear anchors make the 3x3 system singular and would poison
        # the whole mesh with silent NaNs (the default anchors, the first
        # three mesh vertices, ARE collinear for structured grids)
        v2 = vertices_2d.detach().cpu().numpy()
        area2 = np.abs(
            (v2[:, 1, 0] - v2[:, 0, 0]) * (v2[:, 2, 1] - v2[:, 0, 1])
            - (v2[:, 1, 1] - v2[:, 0, 1]) * (v2[:, 2, 0] - v2[:, 0, 0])
        )
        scale = np.maximum(np.abs(v2).max(axis=(1, 2)) ** 2, 1.0)
        if (area2 < 1e-12 * scale).any():
            bad = int(np.argmax(area2 < 1e-12 * scale))
            raise ValueError(
                f"fracture {bad}: anchor vertices are (nearly) collinear; "
                "pass anchor_vertices_2d with three non-collinear points "
                "matching rows of fractures_3d_data"
            )

        extended = torch.cat(
            [vertices_2d, torch.ones_like(vertices_3d[..., :1])], dim=-1
        )  # (B, 3, 3)
        linear_equation = vertices_3d.mT @ torch.linalg.inv(extended).mT  # (B, 3, 3)

        jac = linear_equation[..., :2]  # (B, 3, 2)
        translation = linear_equation[..., 2:]  # (B, 3, 1)

        det = torch.linalg.norm(
            torch.linalg.cross(jac[..., 0], jac[..., 1], dim=-1), dim=-1
        )[..., None, None]  # (B, 1, 1)

        # Moore-Penrose pseudo-inverse: tangential-gradient projector
        inv_jac = torch.linalg.inv(jac.mT @ jac) @ jac.mT  # (B, 2, 3)

        self["jacobian_fracture_map"] = jac
        self["inv_jacobian_fracture_map"] = inv_jac
        self["det_jacobian_fracture_map"] = det
        self["translation_vector"] = translation
