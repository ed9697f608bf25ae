"""P1/P2/P3 basis over a glued discrete fracture network of ``FracturesTri``.

Counterpart of ``pytorch_fem_solver_tpu/basis/fracture_basis.py``.
Pressure continuity across fracture intersections (traces) is enforced by
DOF identification: the 3D vertex coordinates of all fractures are grouped
with a tolerance on the host (NumPy float64, ``mesh.dedup``) into one global
triangulation, and assembly scatters into its DOFs (P2/P3: the edge DOFs
of the global edges, shared across the traces). The shape-function
gradients are the tangential 3D gradients (2D gradients times the chart's
pseudo-inverse) and the weights carry the chart's area scale.

``interpolate`` evaluates a global DOF vector on the basis itself and takes
the two-sided traces onto ``InteriorEdgesFractureBasis``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import config
from ..mesh.dedup import tolerant_group
from ..mesh.meshes_tri import batched_take
from ..mesh.topology import TRI_DIRECTED_EDGES, edge_thirds, p3_edge_dofs, unique_edge_ids
from .abstract_basis import AbstractBasis, dof_tables, host
from .interior_edges_fracture_basis import InteriorEdgesFractureBasis


def _group_rows(coords: np.ndarray, tol: float):
    """(group_ids, counts) of coordinate rows equal within tolerance."""
    scale = max(1.0, float(np.abs(coords).max()))
    ids = tolerant_group(coords, tol * scale)
    return ids, np.bincount(ids)


def build_global_triangulation(mesh, tol: float = 1e-9) -> dict:
    """Glue B fracture meshes into one global conforming triangulation.

    Host-side NumPy on float64 copies of the mesh; returns a dict of tensors
    on the mesh's device (floats in its dtype, indices int32):
      vertices_3D (n_g, 3), vertices_2D (n_g, 2), vertex_markers (n_g,),
      triangles (B*T, 3), edges (E_g, 2), edge_markers (E_g,),
      global2local_idx (B*n_v,), local2global_idx (n_g,),
      traces_global_vertices_idx, traces_global_edges_idx,
      traces_local_edges_idx (B, K), traces_interior_edges_idx (B, K).
    """
    coords3d = host(mesh["vertices", "coordinates_3d"]).astype(np.float64)
    coords2d = host(mesh["vertices", "coordinates"]).astype(np.float64)
    markers = host(mesh["vertices", "markers"]).reshape(coords3d.shape[0], -1)
    cells = host(mesh["cells", "vertices"]).astype(np.int64)
    edges = host(mesh["edges", "vertices"]).astype(np.int64)

    nb_fractures, nb_vertices, _ = coords3d.shape
    nb_edges = edges.shape[-2]

    flat3d = coords3d.reshape(-1, 3)
    global2local_idx, vertex_counts = _group_rows(flat3d, tol)
    nb_global = vertex_counts.shape[0]

    # canonical (minimal) local flat index per global vertex
    local2global_idx = np.full(nb_global, flat3d.shape[0], dtype=np.int64)
    np.minimum.at(local2global_idx, global2local_idx, np.arange(flat3d.shape[0]))

    global_vertices_3d = flat3d[local2global_idx]
    global_vertices_2d = coords2d.reshape(-1, 2)[local2global_idx]

    traces_global_vertices_idx = np.nonzero(vertex_counts > 1)[0]

    # a global DOF is Dirichlet iff ANY local copy is marked boundary
    flat_markers = markers.reshape(-1)
    global_markers = np.zeros(nb_global, dtype=np.int64)
    np.maximum.at(global_markers, global2local_idx, flat_markers)

    vertex_offset = np.arange(nb_fractures)[:, None, None] * nb_vertices
    global_triangles = global2local_idx[cells + vertex_offset].reshape(-1, 3)

    local_edges_global = global2local_idx[edges + vertex_offset].reshape(-1, 2)
    local_edges_sorted = np.sort(local_edges_global, axis=-1)
    global_edges, global2local_edges_idx, edge_counts = np.unique(
        local_edges_sorted, axis=0, return_inverse=True, return_counts=True
    )
    global2local_edges_idx = global2local_edges_idx.reshape(-1)
    nb_global_edges = global_edges.shape[0]

    traces_global_edges_idx = np.nonzero(edge_counts > 1)[0]
    trace_flat = np.nonzero(np.isin(global2local_edges_idx, traces_global_edges_idx))[0]
    # per-fracture local indices of trace edges, padded with -1
    per_fracture = [
        trace_flat[(trace_flat >= b * nb_edges) & (trace_flat < (b + 1) * nb_edges)]
        - b * nb_edges
        for b in range(nb_fractures)
    ]
    k_max = max((len(p) for p in per_fracture), default=0)
    traces_local_edges_idx = np.full((nb_fractures, k_max), -1, dtype=np.int64)
    for b, p in enumerate(per_fracture):
        traces_local_edges_idx[b, : len(p)] = p

    # positions of trace edges inside each fracture's interior-edge list
    # (the axis jump tensors live on); -1 where a trace edge is a boundary
    # edge of that fracture
    interior_vertices = host(mesh["interior_edges", "vertices"])
    traces_interior_edges_idx = np.full((nb_fractures, k_max), -1, dtype=np.int64)
    for b in range(nb_fractures):
        lookup = {
            tuple(pair): pos
            for pos, pair in enumerate(np.sort(interior_vertices[b], axis=-1))
        }
        for k, local_edge in enumerate(per_fracture[b]):
            pair = tuple(np.sort(edges[b, local_edge]))
            traces_interior_edges_idx[b, k] = lookup.get(pair, -1)

    local2global_edges_idx = np.full(
        nb_global_edges, nb_fractures * nb_edges, dtype=np.int64
    )
    np.minimum.at(
        local2global_edges_idx, global2local_edges_idx, np.arange(nb_fractures * nb_edges)
    )

    edge_markers_flat = host(mesh["edges", "markers"]).reshape(-1)
    global_edge_markers = np.zeros(nb_global_edges, dtype=np.int64)
    np.maximum.at(global_edge_markers, global2local_edges_idx, edge_markers_flat)

    device, f, i = mesh.device, mesh.dtype, config.index_dtype()

    def real(a):
        return torch.tensor(a, dtype=f, device=device)

    def index(a):
        return torch.tensor(np.asarray(a).astype(np.int32), dtype=i, device=device)

    return {
        "vertices_3D": real(global_vertices_3d),
        "vertices_2D": real(global_vertices_2d),
        "vertex_markers": index(global_markers),
        "triangles": index(global_triangles),
        "edges": index(global_edges),
        "edge_markers": index(global_edge_markers),
        "global2local_idx": index(global2local_idx),
        "local2global_idx": index(local2global_idx),
        "traces_global_vertices_idx": index(traces_global_vertices_idx),
        "traces_global_edges_idx": index(traces_global_edges_idx),
        "traces_local_edges_idx": index(traces_local_edges_idx),
        "traces_interior_edges_idx": index(traces_interior_edges_idx),
    }


class FractureBasis(AbstractBasis):
    """P1/P2/P3 basis on the glued global DFN triangulation of a
    ``FracturesTri``."""

    def __init__(self, mesh, element, tol: float = 1e-9):
        self.global_triangulation = build_global_triangulation(mesh, tol)
        self.nb_fractures = int(mesh.batch_size()[0])

        super().__init__(mesh, element)

        # correct 2D reference gradients to tangential 3D gradients:
        # (B, T, 1|q, n_loc, 2) @ (B, 1, 1, 2, 3) -> (B, T, 1|q, n_loc, 3)
        inv_frac = mesh["inv_jacobian_fracture_map"][:, None, None]
        self.v_grad = self.v_grad @ inv_frac
        self._inv_map_jacobian = self._inv_map_jacobian @ inv_frac

    def _compute_dofs(self, mesh, element):
        g = self.global_triangulation
        order = element.polynomial_order
        if order == 1:
            coords_4_global_dofs = g["vertices_3D"]
            global_dofs_4_elements = g["triangles"]  # (B*T, 3)
            nodes_4_boundary_dofs = g["vertex_markers"][:, None]
        elif order in (2, 3):
            # the glued triangulation, as FractureNetworkBasis on the flat
            # layout: trace edges carry the same global vertex pair in every
            # incident fracture, so the edge DOFs are shared; the P3 bubble
            # is per (fracture, cell)
            like = g["vertices_3D"]
            gverts = host(like).astype(np.float64)
            gcells = host(g["triangles"]).astype(np.int64)
            gedges = host(g["edges"]).astype(np.int64)  # sorted rows
            edge_markers = host(g["edge_markers"]).reshape(-1)
            vmark = host(g["vertex_markers"]).reshape(-1)
            n_gverts, n_cells = gverts.shape[0], gcells.shape[0]
            # an edge DOF is Dirichlet iff its edge is a boundary edge of at
            # least one incident fracture (edge_markers is the OR over
            # fractures) and both endpoints are marked
            edge_dirichlet = (
                (edge_markers != 0)
                & (vmark[gedges[:, 0]] != 0)
                & (vmark[gedges[:, 1]] != 0)
            ).astype(np.int64)
            cell_edges = unique_edge_ids(gcells, gedges, n_gverts)
            if order == 2:
                coords = np.concatenate([gverts, gverts[gedges].mean(axis=1)], axis=0)
                dofs = np.concatenate([gcells, cell_edges + n_gverts], axis=1)
                markers = np.concatenate([vmark, edge_dirichlet], axis=0)
            else:
                directed = gcells[:, TRI_DIRECTED_EDGES]
                bubble = n_gverts + 2 * gedges.shape[0] + np.arange(n_cells)
                coords = np.concatenate(
                    [gverts, edge_thirds(gverts, gedges), gverts[gcells].mean(axis=1)], axis=0
                )
                dofs = np.concatenate(
                    [gcells, p3_edge_dofs(directed, cell_edges, n_gverts), bubble[:, None]],
                    axis=1,
                )
                markers = np.concatenate(
                    [vmark, np.repeat(edge_dirichlet, 2), np.zeros(n_cells, dtype=np.int64)]
                )
            coords_4_global_dofs, global_dofs_4_elements, nodes_4_boundary_dofs = (
                dof_tables(coords, dofs, markers, like)
            )
        else:
            raise NotImplementedError("Polynomial order not implemented")
        coords_4_elements = coords_4_global_dofs[global_dofs_4_elements.long()]
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
        )

    # -- geometry -----------------------------------------------------------

    def _compute_jacobian_map(self, mesh, element):
        coords = mesh["cells", "coordinates"]
        return coords.mT @ element.barycentric_grad.to(coords)

    def _compute_integration_points(self, mesh, bar_coords):
        # quadrature points directly in 3D via the lifted cell coordinates
        return bar_coords.mT @ mesh["cells", "coordinates_3d"][..., None, :, :]

    def _compute_integral_weights(self, element, det_map_jacobian):
        # 2D reference measure x per-fracture area scale ||j1 x j2||
        scale = self.mesh["det_jacobian_fracture_map"][..., None, None]
        weights = element.gaussian_weights.to(det_map_jacobian)
        return element.reference_element_area * weights * det_map_jacobian * scale

    def interpolate(self, basis, tensor: Optional[torch.Tensor] = None):
        """Evaluate a *global* DOF vector on this basis, ``(B, T, q, 1, 1)``
        and ``(B, T, 1|q, 1, 3)`` (a quadrature axis of 1 for P1, whose
        gradients are constant per cell), or on the fracture interior-edge
        basis: two-sided traces ``(B, Ei, 2, q, 1, 1)`` and ``(B, Ei, 2,
        1|q, 1, 3)`` for flux jumps. Without ``tensor``, the callables
        ``interpolator(f)`` / ``interpolator_grad(f)`` of a function's
        samples at the global DOF coordinates."""
        B = self.nb_fractures
        n_loc = self._global_dofs4elements.shape[-1]

        if basis is self:
            dof_idx = self._global_dofs4elements.long().reshape(B, -1, 1, n_loc)
            v, v_grad = self.v, self.v_grad
        elif isinstance(basis, InteriorEdgesFractureBasis):
            cells = basis.mesh["interior_edges", "cells"].long()  # (B, Ei, 2)
            triangles = self._global_dofs4elements.long().reshape(B, -1, n_loc)
            # (B, Ei, 2, 1, n_loc)
            dof_idx = batched_take(triangles, cells)[..., None, :]
            first_vertex = batched_take(
                self.mesh["cells", "coordinates_3d"][..., :1, :], cells
            )[..., None, :, :]  # (B, Ei, 2, 1, 1, 3)
            inv_map = batched_take(self._inv_map_jacobian, cells)  # (B, Ei, 2, 1, 2, 3)
            pts = basis.integration_points[:, :, None]  # (B, Ei, 1, q, 1, 3)
            ref_pts = self._element.compute_inverse_map(
                first_vertex, pts, inv_map
            )  # (B, Ei, 2, q, 1, 2)
            bar_coords = self._element.compute_barycentric_coordinates(
                ref_pts.squeeze(-2)
            )  # (B, Ei, 2, q, n_loc, 1)
            v, v_grad = self._element.compute_shape_functions(bar_coords, inv_map)
        else:
            raise NotImplementedError(
                f"Interpolation to {type(basis).__name__} not implemented"
            )

        if tensor is not None:
            values = tensor[dof_idx]
            return (values * v).sum(-2, keepdim=True), (values * v_grad).sum(
                -2, keepdim=True
            )

        def _global_nodal_values(function):
            # samples at the global DOF coordinates, with a trailing
            # component axis forced: a scalar function returning (N,) would
            # otherwise broadcast against the trailing 1 of v / v_grad
            vals = function(self._coords4global_dofs)
            return vals.reshape(vals.shape[0], -1)

        def interpolator(function):
            return (_global_nodal_values(function)[dof_idx] * v).sum(-2, keepdim=True)

        def interpolator_grad(function):
            return (_global_nodal_values(function)[dof_idx] * v_grad).sum(
                -2, keepdim=True
            )

        return interpolator, interpolator_grad

