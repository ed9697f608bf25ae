"""Linear elasticity in vector P1 on a single tetrahedral mesh:

    E(x) [2 mu eps(u) : eps(v) + lambda div u div v] = f . v,

mu = 1 / (2 (1 + nu)), lambda = nu / ((1 + nu) (1 - 2 nu)) with the
configuration's ``material.poisson_ratio``, E the traffic's coefficient
field, f the configuration's vector load (a module of ``loads/``
returning (..., 3)) plus the traffic's load field on each component, and
u = 0 on the whole boundary. The program solves it through
``VectorBasis`` and the entry point's M (``"auto"``: the rigid-body-mode
two-level M); its plain reference is ``reference/elasticity_p1.py``.
``answer`` is the (vertices, 3) displacement; ``u_err`` is the largest
max-norm gap over vertices and components over max |u_ref|, over the
compared answers. The control of a float32 mix is the reference with its
operator and load rounded to TF32; of a float64 mix, the reference in
float32.
"""

from __future__ import annotations

import importlib
import math
import sys
import time

import numpy as np
import torch

from ..fields import params
from ..forms import DeviceField

COMPARED = ("u_err",)
CONTROL = {"float32": "tf32", "float64": "float32"}
COMPONENTS = 3


def _base_load(cfg: dict):
    return importlib.import_module(f"fem_bench.loads.{cfg['load']}").at


def _nu(cfg: dict) -> float:
    return float(cfg["material"]["poisson_ratio"])


class ElasticForms:
    """The Lame form scaled by E(x) and the body force, written as a user
    writes forms for the port's ``VectorBasis``: ``V.v_grad`` is
    (T, 1|q, n, 3, 3), row c the gradient of component c."""

    def __init__(self, coefficient, load, base_load, nu: float, device, dtype):
        self.E = DeviceField(coefficient, device, dtype)
        self.f = DeviceField(load, device, dtype)
        self.base_load = base_load
        self.mu, self.lam = 1.0 / (2.0 * (1.0 + nu)), nu / ((1.0 + nu) * (1.0 - 2.0 * nu))

    def set(self, e_params, f_params) -> None:
        if e_params is not None:
            self.E.set(e_params)
        if f_params is not None:
            self.f.set(f_params)

    def a(self, V):
        g = V.v_grad
        eps = 0.5 * (g + g.transpose(-1, -2))
        div = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)  # (T, 1|q, n)
        k = (2.0 * self.mu) * torch.einsum("...icd,...jcd->...ij", eps, eps) + self.lam * (
            div[..., :, None] * div[..., None, :])
        return self.E.at(V.integration_points) * k

    def l(self, V):  # noqa: E743 - the linear form's usual name
        x = V.integration_points  # (T, q, 1, 3)
        f = self.base_load(x)
        s = self.f.spec
        if not (s.constant and s.transform == "affine" and s.mean == 0.0):
            f = f + self.f.at(x)
        return (f * V.v).sum(-1, keepdim=True)


def program(cell, inputs: dict, specs: dict, device, dtype):
    from pytorch_fem_solver_tpu_torch import ElementTet, MeshTet, VectorBasis

    mesh = MeshTet({"vertices": inputs["vertices"], "tetrahedra": inputs["tetrahedra"]},
                   device=device, dtype=dtype)
    element = cell.config["element"]
    basis = VectorBasis(mesh, ElementTet(element["order"], element["quadrature_degree"]))
    forms = ElasticForms(specs["coefficient"], specs["load"], _base_load(cell.config),
                         _nu(cell.config), device, dtype)
    return basis, forms


def answer(cell, basis, u) -> np.ndarray:
    """(vertices, 3): the DOFs are node-major, and a node is a vertex."""
    return u.reshape(-1, COMPONENTS).double().cpu().numpy()


def control_for(cell) -> str:
    return CONTROL[cell.traffic["dtype"]]


def compare(cell, inputs: dict, specs: dict, answers: list, seed: int, device,
            control: str | None = None):
    from ..reference import elasticity_p1, p1
    from ..work import reduced_nonzeros

    glued = importlib.import_module(f"fem_bench.reference.{cell.config['mesh']['kind']}").glue(inputs)
    ref = elasticity_p1.Reference(glued, device, int(cell.config["element"]["quadrature_degree"]),
                                  _nu(cell.config))
    base = _base_load(cell.config)
    worst, most, t0 = 0.0, 0, time.perf_counter()
    for i, u in answers:
        p = params(specs, seed, i)
        fe, fg = (p1.field_function(specs[r], p[r], ref.device) for r in ("coefficient", "load"))

        def ff(x, fg=fg):
            return base(x) + fg(x)[..., None]
        u_ref, iters = ref.solve(fe, ff)
        most = max(most, iters)
        u_ref = u_ref.cpu().numpy()[glued.vertex_node]
        if control is not None:
            u = ref.solve(fe, ff, control=control)[0].cpu().numpy()[glued.vertex_node]
        gap = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        # a reference that did not converge judges nothing
        worst = math.nan if math.isnan(gap) or iters >= p1.MAXITER else max(worst, gap)
    seconds = (time.perf_counter() - t0) / max(1, len(answers))
    print(f"reference: {len(answers)} solves, up to {most} CG iterations, {seconds:.3f} s an "
          "answer", file=sys.stderr)

    def work() -> dict:
        nnz, rows = reduced_nonzeros(glued.cells, glued.dirichlet)
        return {"nnz": COMPONENTS**2 * nnz, "rows": COMPONENTS * rows}

    return {"u_err": worst if answers else math.nan}, work
