"""Modal analysis of a clamped linear-elastic solid in vector P1: the k
smallest pairs of

    E(x) [2 mu eps(u) : eps(v) + lambda div u div v] = omega^2 rho u . v,

mu, lambda and E as in ``elasticity_p1.py`` (the configuration's
``material.poisson_ratio``, the traffic's coefficient field), rho the
configuration's ``material.density``, u = 0 on the whole boundary; no load
(the configuration's ``load`` and the traffic's load field are not read).
The program solves it through ``VectorBasis.compiled_eigsh`` with the forms
``a`` (the Lame form scaled by E) and ``m`` (rho v . v); its plain reference
is ``reference/elasticity_modes_p1.py``, which solves the same pencil in
float64 with an eigensolver of its own.

``answer`` is the sorted eigenvalues and the (vertices, 3, k) modes. The
compared numbers, over the compared answers:

* ``lam_err``: the largest max_i |lambda_i - lambda_i^ref| / lambda_i^ref;
* ``res_err``: the largest ||K x_i - lambda_i M x_i|| / (||K x_i|| +
  lambda_i ||M x_i||) of the program's pairs, in the reference's float64 K
  and M.

Modes are never compared one by one: a cluster of close eigenvalues may
come out in any rotation. The control of a float32 mix is the reference
with K and M rounded to TF32.
"""

from __future__ import annotations

import importlib
import math
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..fields import params
from .elasticity_p1 import COMPONENTS, ElasticForms, _nu

COMPARED = ("lam_err", "res_err")
CONTROL = {"float32": "tf32"}


class Answer(NamedTuple):
    values: np.ndarray  # (k,) ascending
    modes: np.ndarray  # (vertices, 3, k)


def _rho(cfg: dict) -> float:
    return float(cfg["material"]["density"])


class ModalForms(ElasticForms):
    """``ElasticForms`` with the mass form ``m`` (rho v . v); its load is
    left unused."""

    def __init__(self, coefficient, load, nu: float, rho: float, device, dtype):
        super().__init__(coefficient, load, None, nu, device, dtype)
        self.rho = rho

    def m(self, V):
        return self.rho * torch.einsum("...ic,...jc->...ij", V.v, V.v)


def program(cell, inputs: dict, specs: dict, device, dtype):
    from pytorch_fem_solver_tpu_torch import ElementTet, MeshTet, VectorBasis

    mesh = MeshTet({"vertices": inputs["vertices"], "tetrahedra": inputs["tetrahedra"]},
                   device=device, dtype=dtype)
    element = cell.config["element"]
    basis = VectorBasis(mesh, ElementTet(element["order"], element["quadrature_degree"]))
    forms = ModalForms(specs["coefficient"], specs["load"], _nu(cell.config), _rho(cell.config),
                       device, dtype)
    return basis, forms


def answer(cell, basis, u) -> Answer:
    """``u`` is the entry's ``(values (k,), vectors (n_dofs, k))``; the DOFs
    are node-major, and a node is a vertex."""
    vals, vecs = u
    order = torch.argsort(vals)
    vecs = vecs[:, order]
    return Answer(vals[order].double().cpu().numpy(),
                  vecs.reshape(-1, COMPONENTS, vecs.shape[-1]).double().cpu().numpy())


def control_for(cell) -> str:
    return CONTROL[cell.traffic["dtype"]]


def compare(cell, inputs: dict, specs: dict, answers: list, seed: int, device,
            control: str | None = None):
    from ..reference import elasticity_modes_p1 as modal
    from ..reference import p1
    from ..work import reduced_nonzeros

    glued = importlib.import_module(f"fem_bench.reference.{cell.config['mesh']['kind']}").glue(inputs)
    ref = modal.Reference(glued, device, int(cell.config["element"]["quadrature_degree"]),
                          _nu(cell.config), _rho(cell.config))
    lam_err = res_err = 0.0
    steps, t0 = 0, time.perf_counter()
    for i, ans in answers:
        E = p1.field_function(specs["coefficient"], params(specs, seed, i)["coefficient"],
                              ref.device)
        kv = ref.stiffness_values(E)
        k = len(ans.values)
        exact = ref.modes(kv, k)
        steps = max(steps, exact.steps)
        if control is not None:
            ctl = ref.modes(kv, k, control=control)
            lam, x = ctl.values, ctl.vectors
        else:
            lam = torch.as_tensor(ans.values, device=ref.device)
            x = ref.interior(ans.modes, glued.vertex_node)
        gap = float(((lam - exact.values).abs() / exact.values).max())
        res = float(ref.residuals(kv, ref.mass, lam, x).max())
        if not exact.converged or math.isnan(gap) or math.isnan(res):
            # a reference that did not converge judges nothing; a NaN pair fails
            lam_err = res_err = math.nan
        elif not math.isnan(lam_err):
            lam_err, res_err = max(lam_err, gap), max(res_err, res)
    seconds = (time.perf_counter() - t0) / max(1, len(answers))
    print(f"reference: {len(answers)} eigensolves, up to {steps} block steps, {seconds:.3f} s an "
          "answer", file=sys.stderr)

    def work() -> dict:
        nnz, rows = reduced_nonzeros(glued.cells, glued.dirichlet)
        return {"nnz": COMPONENTS**2 * nnz, "rows": COMPONENTS * rows,
                "value_bytes": torch.finfo(getattr(torch, cell.traffic["dtype"])).bits // 8}

    if not answers:
        lam_err = res_err = math.nan
    return {"lam_err": lam_err, "res_err": res_err}, work
