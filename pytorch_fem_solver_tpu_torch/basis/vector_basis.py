"""Vector-valued Lagrange basis (elasticity-type PDEs).

Counterpart of ``pytorch_fem_solver_tpu/basis/vector_basis.py``.
``VectorBasis`` lifts a scalar :class:`Basis` to ``n_components`` coupled
components with an *interleaved* DOF layout (node-major, component-minor):
the DOF of (node i, component c) is ``i * n_components + c``. The
components of one node then land in the same 8-block of the BSR layout, so
the block smoothers see the inter-component coupling of each node, and the
rigid-body-mode coarse space (``ops.precondition.elasticity_rbm_modes``)
stays a reshape over contiguous aggregates.

Shape convention (extends the scalar ``(..., T, q, n_loc, ...)`` one):

* ``v``:       ``(q, n_vloc, nc)``         vector shape functions φ_i e_c
* ``v_grad``:  ``(T, 1|q, n_vloc, nc, d)`` per-DOF Jacobians
* forms contract the trailing component/space axes to the scalar layout:
  bilinear integrands ``(T, q, n_vloc, n_vloc)``, linear integrands
  ``(T, q, n_vloc, 1)``, so every assembly, solve and preconditioner path
  takes them unchanged.

``n_vloc = n_loc * nc``. P1, P2 and P3 elements. The DOF tables are lifted
on the host in NumPy int64 and go through ``abstract_basis.dof_tables``,
so they are byte-identical to the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .abstract_basis import dof_tables, host
from .basis import Basis


class VectorBasis(Basis):
    """``n_components``-valued Lagrange basis on mesh cells.

    Dirichlet nodes clamp every component by default; pass
    ``dirichlet_components`` to constrain a subset (e.g. ``(1,)`` for a
    roller boundary fixing only the y-component at marked nodes).
    """

    def __init__(
        self,
        mesh,
        element,
        n_components: Optional[int] = None,
        dirichlet_components: Optional[tuple] = None,
    ):
        if n_components is None:
            n_components = int(mesh["vertices", "coordinates"].shape[-1])
        self.n_components = int(n_components)
        if self.n_components < 1:
            raise ValueError(f"n_components must be >= 1, got {n_components}")
        if dirichlet_components is not None:
            bad = [
                c for c in dirichlet_components
                if not 0 <= int(c) < self.n_components
            ]
            if bad:
                raise ValueError(
                    f"dirichlet_components {bad} out of range for "
                    f"{self.n_components} components"
                )
        self._dirichlet_components = (
            None
            if dirichlet_components is None
            else tuple(int(c) for c in dirichlet_components)
        )
        super().__init__(mesh, element)

        # each scalar local function φ_l becomes nc functions φ_l e_c with
        # value vector δ_{cC} φ_l and Jacobian δ_{cC} ∇φ_l
        nc = self.n_components
        eye = torch.eye(nc, dtype=self.v.dtype, device=self.v.device)
        q, n_loc, _ = self.v.shape
        self.v = torch.einsum("qlo,cC->qlcC", self.v, eye).reshape(q, n_loc * nc, nc)
        t, qg, _, d = self.v_grad.shape
        self.v_grad = torch.einsum(
            "tqld,cC->tqlcCd", self.v_grad, eye.to(self.v_grad.dtype)
        ).reshape(t, qg, n_loc * nc, nc, d)

    # -- DOF lifting --------------------------------------------------------

    def _compute_dofs(self, mesh, element):
        coords_s, dofs_s, marks_s, _ = super()._compute_dofs(mesh, element)
        nc = self.n_components
        like = coords_s

        coords_s = host(coords_s)
        dofs_s = host(dofs_s)
        marks_s = host(marks_s).reshape(-1)

        # interleaved layout: DOF(node i, comp c) = i*nc + c
        coords_v = np.repeat(coords_s, nc, axis=0)
        dofs_v = (
            dofs_s[..., None].astype(np.int64) * nc + np.arange(nc)
        ).reshape(dofs_s.shape[0], -1)
        if self._dirichlet_components is None:
            marks_v = np.repeat(marks_s, nc)
        else:
            comp_mask = np.zeros(nc, dtype=marks_s.dtype)
            comp_mask[list(self._dirichlet_components)] = 1
            marks_v = (marks_s[:, None] * comp_mask[None, :]).reshape(-1)

        coords_4_global_dofs, global_dofs_4_elements, nodes_4_boundary_dofs = dof_tables(
            coords_v, dofs_v, marks_v, like
        )
        coords_4_elements = coords_4_global_dofs[global_dofs_4_elements.long()]
        return (
            coords_4_global_dofs,
            global_dofs_4_elements,
            nodes_4_boundary_dofs,
            coords_4_elements,
        )

    # -- interpolation ------------------------------------------------------

    def interpolate(self, basis, tensor: Optional[torch.Tensor] = None):
        """Evaluate a DOF vector at this basis's quadrature points.

        Returns ``(values, jacobian)`` with shapes ``(T, q, 1, nc)`` and
        ``(T, q, 1, nc, d)``. Only self-interpolation is implemented for
        vector fields, as in the JAX package.
        """
        if basis is not self:
            raise NotImplementedError("VectorBasis only interpolates onto itself")
        if tensor is None:
            raise NotImplementedError("VectorBasis.interpolate requires a DOF vector")
        dof_idx = self._global_dofs4elements.long()[..., None, :]  # (T, 1, n_vloc)
        values = tensor[dof_idx]  # (T, 1, n_vloc, 1)
        u = (values * self.v).sum(-2, keepdim=True)  # (T, q, 1, nc)
        # (T, q, 1, nc, d): contract the n_vloc axis of the per-DOF Jacobians
        u_grad = (values[..., None] * self.v_grad).sum(-3, keepdim=True)
        return u, u_grad
