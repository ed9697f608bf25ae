"""Cell-volume basis on a single triangle or tetrahedral mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/basis.py``: the P1, P2 and
P3 DOF maps of triangles and tetrahedra. ``interpolate`` evaluates on the
basis's own quadrature points and takes the two-sided and one-sided traces
onto the facet bases (the edges of a triangle mesh, the faces of a tet
mesh); ``probe`` evaluates at scattered points (located on the host with
scipy's kd-tree, evaluated on the basis's device). Local
entry (i, j) lands at global (row_i, col_j); the DOF tables and
interior-DOF lists are computed on the host once (NumPy, float64) and move
to the mesh's device.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..mesh.topology import (
    TET_EDGE_PERMUTATIONS,
    TET_FACE_PERMUTATIONS,
    TRI_DIRECTED_EDGES,
    edge_thirds,
    face_bubble_markers,
    p2_edge_dirichlet_markers,
    p3_edge_dofs,
    unique_edge_ids,
    unique_face_ids,
)
from .abstract_basis import AbstractBasis, dof_tables, host
from .interior_edges_basis import InteriorEdgesBasis


class Basis(AbstractBasis):
    """Lagrange basis over mesh cells: P1 (vertices), P2 (vertices + edge
    midpoints) or P3 (vertices + two oriented edge nodes + one bubble per
    cell on triangles, per unique face on tetrahedra)."""

    def _compute_dofs(self, mesh, element):
        order = element.polynomial_order
        if order == 1:
            coords_4_global_dofs = mesh["vertices", "coordinates"]
            global_dofs_4_elements = mesh["cells", "vertices"]
            nodes_4_boundary_dofs = mesh["vertices", "markers"]
        elif order in (2, 3):
            like = mesh["vertices", "coordinates"]
            verts = host(like).astype(np.float64)
            cells = host(mesh["cells", "vertices"]).astype(np.int64)
            is_tet = cells.shape[-1] == 4
            edges = host(mesh["edges", "vertices"]).astype(np.int64)
            vert_markers = host(mesh["vertices", "markers"]).reshape(-1)
            edge_markers = p2_edge_dirichlet_markers(
                edges, host(mesh["edges", "markers"]), vert_markers
            )
            n_vertices = verts.shape[0]
            cell_edges = unique_edge_ids(cells, edges, n_vertices)
            if order == 2:
                # one DOF per unique edge, at its midpoint
                coords = np.concatenate([verts, verts[edges].mean(axis=1)], axis=0)
                dofs = np.concatenate([cells, cell_edges + n_vertices], axis=1)
                markers = np.concatenate([vert_markers, edge_markers], axis=0)
            else:
                # two oriented DOFs per unique edge, then the bubbles: the
                # cell's barycenter on triangles, each unique face's on tets
                n_edges, n_cells = edges.shape[0], cells.shape[0]
                first_bubble = n_vertices + 2 * n_edges
                if is_tet:
                    directed = cells[:, TET_EDGE_PERMUTATIONS]
                    faces = host(mesh["faces", "vertices"]).astype(np.int64)
                    bubble = first_bubble + unique_face_ids(
                        faces, cells[:, TET_FACE_PERMUTATIONS], n_vertices
                    )
                    bubble_coords = verts[faces].mean(axis=1)
                    bubble_markers = face_bubble_markers(
                        faces, host(mesh["faces", "markers"]), vert_markers
                    )
                else:
                    directed = cells[:, TRI_DIRECTED_EDGES]
                    bubble = (first_bubble + np.arange(n_cells))[:, None]
                    bubble_coords = verts[cells].mean(axis=1)
                    bubble_markers = np.zeros(n_cells, np.int64)
                coords = np.concatenate(
                    [verts, edge_thirds(verts, edges), bubble_coords], axis=0
                )
                dofs = np.concatenate(
                    [cells, p3_edge_dofs(directed, cell_edges, n_vertices), bubble], axis=1
                )
                markers = np.concatenate(
                    [vert_markers, np.repeat(edge_markers, 2), bubble_markers]
                )
            coords_4_global_dofs, global_dofs_4_elements, nodes_4_boundary_dofs = (
                dof_tables(coords, dofs, markers, like)
            )
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
        )

    def _compute_jacobian_map(self, mesh, element):
        coords = self._cell_coordinates(mesh)
        return coords.mT @ element.barycentric_grad.to(coords)

    def _locate_cells(self, points: np.ndarray, tol: float) -> np.ndarray:
        """Host-side point location: the containing cell's id per query
        point (int64 NumPy), as the JAX package finds it.

        A kd-tree over the cell centroids, then a barycentric inside-test
        over the nearest 8, then 64 candidates, then all cells in chunks of
        2^16 one point at a time. Raises ``ValueError`` for a point outside
        the mesh (beyond ``tol`` in barycentric terms).
        """
        from scipy.spatial import cKDTree

        coords = host(self.mesh["cells", "coordinates"]).astype(np.float64)  # (T, k, d)
        n_cells, k, d = coords.shape
        if k != d + 1:
            raise NotImplementedError(
                "probe needs a flat simplex mesh (dim == ambient dim); "
                "embedded fracture bases are not supported"
            )
        pts = np.asarray(points, dtype=np.float64).reshape(-1, d)
        tree = cKDTree(coords.mean(axis=1))
        found = np.full(pts.shape[0], -1, dtype=np.int64)
        # barycentric via the affine system [1; x] = [[1..1]; V^T] lam
        a_mat = np.concatenate([np.ones((n_cells, 1, k)), coords.transpose(0, 2, 1)], axis=1)

        def _try(miss, cand):
            rhs = np.concatenate([np.ones((miss.size, 1)), pts[miss]], axis=1)  # (M, k)
            lam = np.linalg.solve(a_mat[cand], rhs[:, None, :, None])  # (M, kk, k, 1)
            inside = (lam[..., 0] >= -tol).all(axis=-1)  # (M, kk)
            hit = inside.any(axis=1)
            first = inside.argmax(axis=1)
            found[miss[hit]] = cand[np.arange(miss.size), first][hit]

        for k_try in (8, 64):
            miss = np.flatnonzero(found < 0)
            if miss.size == 0:
                break
            kk = min(k_try, n_cells)
            _, cand = tree.query(pts[miss], k=kk)
            _try(miss, cand.reshape(miss.size, kk))
        chunk = 1 << 16
        for p_idx in np.flatnonzero(found < 0):
            for start in range(0, n_cells, chunk):
                _try(np.asarray([p_idx]), np.arange(start, min(start + chunk, n_cells))[None, :])
                if found[p_idx] >= 0:
                    break
        if (found < 0).any():
            bad = pts[np.flatnonzero(found < 0)[0]]
            raise ValueError(f"probe point outside the mesh (first offender: {bad})")
        return found

    def probe(self, points, tensor: torch.Tensor, tol: float = 1e-10):
        """Evaluate a DOF vector at arbitrary physical points.

        The points are located on the host (``_locate_cells``); the inverse
        affine map, the shape functions and the sums run on the basis's
        device, in its dtype, through the element's own functions (as the
        traces of ``interpolate`` do).

        Args:
          points: (P, d) physical coordinates inside the mesh.
          tensor: (n_dofs, 1) DOF vector (e.g. a solve result).
          tol: barycentric tolerance for the inside test.

        Returns ``(values, grads)`` with shapes ``(P,)`` and ``(P, d)`` for
        scalar bases, ``(P, nc)`` and ``(P, nc, d)`` for vector bases.
        """
        coords = self.mesh["vertices", "coordinates"]
        d = int(coords.shape[-1])
        pts = np.asarray(points, dtype=np.float64).reshape(-1, d)
        cells = torch.as_tensor(self._locate_cells(pts, tol), device=coords.device)
        pts_t = torch.as_tensor(pts, dtype=coords.dtype, device=coords.device)

        first_vertex = self.mesh["cells", "coordinates"][cells][:, None, [0], :]  # (P, 1, 1, d)
        inv_jac = self._inv_map_jacobian[cells]  # (P, 1, d, d)
        ref = self._element.compute_inverse_map(
            first_vertex, pts_t[:, None, None, :], inv_jac
        )  # (P, 1, 1, d)
        bar = self._element.compute_barycentric_coordinates(ref.squeeze(-2))  # (P, 1, n_bar, 1)
        v, v_grad = self._element.compute_shape_functions(bar, inv_jac)
        dof_vals = tensor[self._global_dofs4elements.long()[cells]][:, None]  # (P, 1, n_loc[*nc], 1)
        nc = int(getattr(self, "n_components", 1))
        if nc >= 2:
            # lift the scalar shape tables to the vector layout exactly as
            # VectorBasis.__init__ does (phi_l e_c, interleaved)
            eye = torch.eye(nc, dtype=v.dtype, device=v.device)
            p_n, one, n_loc, _ = v.shape
            v = torch.einsum("polu,cC->polcC", v, eye).reshape(p_n, one, n_loc * nc, nc)
            dd = v_grad.shape[-1]
            v_grad = torch.einsum("pold,cC->polcCd", v_grad, eye.to(v_grad.dtype)).reshape(
                p_n, one, n_loc * nc, nc, dd
            )
            values = (dof_vals * v).sum(-2)[:, 0]  # (P, nc)
            grads = (dof_vals[..., None] * v_grad).sum(-3)[:, 0]  # (P, nc, d)
        else:
            values = (dof_vals * v).sum(-2)[:, 0, 0]  # (P,)
            grads = (dof_vals * v_grad).sum(-2)[:, 0]  # (P, d)
        return values, grads

    def _cell_coordinates(self, mesh):
        return mesh["cells", "coordinates"]

    def _interp_cell_coordinates(self):
        """Cell coordinates in the space the traces' points live in
        (3D for the embedded network basis)."""
        return self.mesh["cells", "coordinates"]

    def _compute_integration_points(self, mesh, bar_coords):
        return bar_coords.mT @ self._cell_coordinates(mesh)[..., None, :, :]

    def interpolate(self, basis, tensor: Optional[torch.Tensor] = None):
        """Evaluate a DOF vector (or nodal samples of a function) on another
        basis's quadrature points.

        * ``basis is self``: per-cell values and gradients at this basis's
          own quadrature points, ``(T, q, 1, 1)`` and ``(T, 1|q, 1, d)``
          (a quadrature axis of 1 for P1, whose gradients are constant per
          cell).
        * ``basis`` an :class:`InteriorEdgesBasis` (or an
          :class:`InteriorFacesBasis` of a tet mesh): two-sided traces. The
          facet quadrature points are pulled back into each adjacent cell's
          reference coordinates and the shape functions evaluated there,
          with a cell-pair axis at dim -4: ``(E, 2, q, 1, 1)`` and
          ``(E, 2, 1|q, 1, d)`` (jump terms).
        * ``basis`` a :class:`BoundaryEdgesBasis` (or
          :class:`BoundaryFacesBasis`): one-sided traces, the same with a
          side axis of size 1 (boundary fluxes).

        With ``tensor`` (n_dofs, 1) returns ``(values, gradients)``; without
        it, the pair of callables ``interpolator(f)`` and
        ``interpolator_grad(f)`` that do the same for the nodal samples
        ``f(coords)`` of a function (a network: autograd flows through the
        gather into its parameters).
        """
        if basis is self:
            dof_idx = self._global_dofs4elements[..., None, :]  # (T, 1, n_loc)
            v, v_grad = self.v, self.v_grad
        elif isinstance(basis, InteriorEdgesBasis):
            cells = basis._adjacent_cells()  # (E, n_sides) int64
            # (E, n_sides, 1, n_loc): DOF ids of the adjacent cells
            dof_idx = self._global_dofs4elements.long()[cells][..., None, :]
            # (E, n_sides, 1, 1, d): first vertex of each adjacent cell
            first_vertex = self._interp_cell_coordinates()[..., [0], :][cells][
                ..., None, :, :
            ]
            inv_map_jacobian = self._inv_map_jacobian[cells]  # (E, s, 1, d_ref, d)
            # edge quadrature points with an inserted side axis (E, 1, q, 1, d)
            pts = basis.integration_points[..., None, :, :, :]
            ref_pts = self._element.compute_inverse_map(
                first_vertex, pts, inv_map_jacobian
            )  # (E, s, q, 1, d_ref)
            bar_coords = self._element.compute_barycentric_coordinates(
                ref_pts.squeeze(-2)
            )  # (E, s, q, n_loc, 1)
            v, v_grad = self._element.compute_shape_functions(
                bar_coords, inv_map_jacobian
            )
        else:
            raise NotImplementedError("Interpolation for this basis not implemented")

        if tensor is not None:
            values = tensor[dof_idx]  # (..., 1, n_loc, 1)
            return (values * v).sum(-2, keepdim=True), (values * v_grad).sum(
                -2, keepdim=True
            )

        nodes = self._coords4global_dofs

        def interpolator(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v).sum(-2, keepdim=True)

        def interpolator_grad(function: Callable[[torch.Tensor], torch.Tensor]):
            return (function(nodes)[dof_idx] * v_grad).sum(-2, keepdim=True)

        return interpolator, interpolator_grad
