"""Batched basis over B patch meshes: one batched assembly and solve.

Counterpart of ``pytorch_fem_solver_tpu/basis/patches_basis.py``: the
assembled shapes are ``(B, n, n)`` / ``(B, n, 1)`` with a leading patch
index in the scatter tuple, so every patch's system assembles in one
scatter-add and solves in one batched LU. ``reduce`` keeps the matrix axes,
``(B, k, k)`` / ``(B, k, 1)``, so batched ``torch.linalg.inv`` / ``solve``
apply directly.

Every patch has the template's topology (``mesh/patches.py``), so the P2/P3
DOF maps are derived once from batch entry 0 on the host and tiled; only
the node coordinates are per patch, computed on the device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config
from ..mesh.topology import (
    TRI_DIRECTED_EDGES,
    p2_edge_dirichlet_markers,
    p3_edge_dofs,
    unique_edge_ids,
)
from .abstract_basis import AbstractBasis, host


class PatchesBasis(AbstractBasis):
    """P1/P2/P3 basis over a batch of patch meshes."""

    def __init__(self, mesh, element):
        self.nb_patches = int(mesh.batch_size()[0])
        self.patches_idx = torch.arange(
            self.nb_patches, dtype=config.index_dtype(), device=mesh.device
        )[:, None]
        super().__init__(mesh, element)

    def _compute_dofs(self, mesh, element):
        order = element.polynomial_order
        if order == 1:
            coords_4_global_dofs = mesh["vertices", "coordinates"]
            global_dofs_4_elements = mesh["cells", "vertices"]
            nodes_4_boundary_dofs = mesh["vertices", "markers"]
        elif order in (2, 3):
            verts = mesh["vertices", "coordinates"]  # (B, n_v, d)
            cells0 = host(mesh["cells", "vertices"])[0].astype(np.int64)
            edges0 = host(mesh["edges", "vertices"])[0].astype(np.int64)
            vmark0 = host(mesh["vertices", "markers"])[0].reshape(-1)
            emark0 = host(mesh["edges", "markers"])[0]
            n_v, n_e, n_c = int(verts.shape[-2]), edges0.shape[0], cells0.shape[0]
            B = self.nb_patches
            cell_edges = unique_edge_ids(cells0, edges0, n_v)
            edge_mark = p2_edge_dirichlet_markers(edges0, emark0, vmark0)
            edges_d = torch.as_tensor(edges0, device=verts.device)
            if order == 2:
                dofs0 = np.concatenate([cells0, n_v + cell_edges], axis=1)
                coords_4_global_dofs = torch.cat(
                    [verts, verts[:, edges_d].mean(dim=-2)], dim=-2
                )
                marks0 = np.concatenate([vmark0, edge_mark])
            else:
                # two DOFs per edge at 1/3 and 2/3, oriented toward the
                # smaller vertex id, and one barycenter bubble per cell
                bubble = n_v + 2 * n_e + np.arange(n_c)
                dofs0 = np.concatenate(
                    [
                        cells0,
                        p3_edge_dofs(cells0[:, TRI_DIRECTED_EDGES], cell_edges, n_v),
                        bubble[:, None],
                    ],
                    axis=1,
                )
                emin = verts[:, edges_d.min(dim=1).values]  # (B, n_e, d)
                emax = verts[:, edges_d.max(dim=1).values]
                edge_nodes = torch.stack(
                    [(2 * emin + emax) / 3.0, (emin + 2 * emax) / 3.0], dim=2
                ).reshape(B, 2 * n_e, -1)
                bubble_coords = verts[:, torch.as_tensor(cells0, device=verts.device)].mean(
                    dim=2
                )
                coords_4_global_dofs = torch.cat([verts, edge_nodes, bubble_coords], dim=-2)
                marks0 = np.concatenate(
                    [vmark0, np.repeat(edge_mark, 2), np.zeros(n_c, np.int64)]
                )
            index = config.index_dtype()
            global_dofs_4_elements = torch.tensor(
                dofs0.astype(np.int32), dtype=index, device=verts.device
            ).expand((B,) + dofs0.shape).contiguous()
            nodes_4_boundary_dofs = torch.tensor(
                marks0.astype(np.int32).reshape(-1, 1), dtype=index, device=verts.device
            ).expand(B, -1, -1).contiguous()
        else:
            raise NotImplementedError("Polynomial order not implemented")

        coords_4_elements = mesh.compute_coordinates_4_cells(
            coords_4_global_dofs, global_dofs_4_elements
        )
        return (
            coords_4_global_dofs,
            global_dofs_4_elements,
            nodes_4_boundary_dofs,
            coords_4_elements,
        )

    def _compute_basis_parameters(
        self, coords4global_dofs, global_dofs4elements, nodes4boundary_dofs
    ):
        return self._build_assembly_parameters(
            int(coords4global_dofs.shape[-2]),
            global_dofs4elements,
            nodes4boundary_dofs,
            batch_size=self.nb_patches,
        )

    def reshape_for_assembly(self, local, form: str):
        if form == "bilinear":
            return local.reshape(self.nb_patches, -1)
        if form == "linear":
            return local.reshape(self.nb_patches, -1, 1)
        raise NotImplementedError(f"Unknown form type: {form}")

    def _compute_jacobian_map(self, mesh, element):
        coords = mesh["cells", "coordinates"]
        return coords.mT @ element.barycentric_grad.to(coords)

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ mesh["cells", "coordinates"][..., None, :, :]
