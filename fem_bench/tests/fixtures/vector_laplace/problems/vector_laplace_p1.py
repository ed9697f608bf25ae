"""The vector Laplacian in P1 on a single tetrahedral mesh:
kappa grad u : grad v over three components, u = 0 on the boundary, with
the load f_c(x) = f0(x) + g(x) + x_c of component c (f0 the
configuration's load, g the traffic's load field), so the components
differ. The program solves it through ``VectorBasis``; its plain reference
is ``reference/vector_laplace_p1.py``. ``u_err`` is the largest max-norm
gap over vertices and components over max |u_ref|.
"""

from __future__ import annotations

import importlib
import math

import numpy as np
import torch

from ..fields import params
from ..forms import DeviceField

COMPARED = ("u_err",)
CONTROL = {"float32": "tf32", "float64": "float32"}
COMPONENTS = 3


def _base_load(cfg: dict):
    return importlib.import_module(f"fem_bench.loads.{cfg['load']}").at


class VectorForms:
    def __init__(self, coefficient, load, base_load, device, dtype):
        self.kappa = DeviceField(coefficient, device, dtype)
        self.f = DeviceField(load, device, dtype)
        self.base_load = base_load

    def set(self, kappa_params, f_params) -> None:
        if kappa_params is not None:
            self.kappa.set(kappa_params)
        if f_params is not None:
            self.f.set(f_params)

    def a(self, V):
        g = V.v_grad  # (T, 1|q, n, c, d)
        return self.kappa.at(V.integration_points) * torch.einsum("...icd,...jcd->...ij", g, g)

    def l(self, V):  # noqa: E743 - the linear form's usual name
        x = V.integration_points  # (T, q, 1, 3)
        f = self.base_load(x) + self.f.at(x) + x
        return (f * V.v).sum(-1, keepdim=True)


def program(cell, inputs: dict, specs: dict, device, dtype):
    from pytorch_fem_solver_tpu_torch import ElementTet, MeshTet, VectorBasis

    mesh = MeshTet({"vertices": inputs["vertices"], "tetrahedra": inputs["tetrahedra"]},
                   device=device, dtype=dtype)
    element = cell.config["element"]
    basis = VectorBasis(mesh, ElementTet(element["order"], element["quadrature_degree"]))
    forms = VectorForms(specs["coefficient"], specs["load"], _base_load(cell.config), device,
                        dtype)
    return basis, forms


def answer(cell, basis, u) -> np.ndarray:
    """(vertices, 3): the DOFs are node-major, and a node is a vertex."""
    return u.reshape(-1, COMPONENTS).double().cpu().numpy()


def control_for(cell) -> str:
    return CONTROL[cell.traffic["dtype"]]


def compare(cell, inputs: dict, specs: dict, answers: list, seed: int, device,
            control: str | None = None):
    from ..reference import p1, vector_laplace_p1
    from ..work import reduced_nonzeros

    glued = importlib.import_module(f"fem_bench.reference.{cell.config['mesh']['kind']}").glue(inputs)
    ref = p1.Reference(glued, device, int(cell.config["element"]["quadrature_degree"]))
    base = _base_load(cell.config)
    worst = 0.0
    for i, u in answers:
        p = params(specs, seed, i)
        fk, fg = (p1.field_function(specs[r], p[r], ref.device) for r in ("coefficient", "load"))
        loads = [lambda x, c=c: base(x)[..., 0] + fg(x) + x[..., c] for c in range(COMPONENTS)]
        u_ref, iters = vector_laplace_p1.solve(ref, fk, loads)
        u_ref = u_ref.cpu().numpy()[glued.vertex_node]
        if control is not None:
            u = vector_laplace_p1.solve(ref, fk, loads, control)[0].cpu().numpy()[glued.vertex_node]
        gap = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        worst = math.nan if math.isnan(gap) or iters >= p1.MAXITER else max(worst, gap)

    def work() -> dict:
        nnz, rows = reduced_nonzeros(glued.cells, glued.dirichlet)
        return {"nnz": COMPONENTS**2 * nnz, "rows": COMPONENTS * rows}

    return {"u_err": worst if answers else math.nan}, work
