"""-div(kappa grad u) = f in P1, u = 0 on the Dirichlet nodes, on any mesh
kind: the program's scalar basis of the mesh kind (``meshes/<kind>.py``),
the forms of ``forms.py``, and the plain reference of ``reference/p1.py``
on the mesh input glued by ``reference/<kind>.py``.

``u_err`` is the largest max-norm gap at the input vertices over max
|u_ref|, over the compared answers. The control of a float32 mix is the
reference with its operator and load rounded to TF32; of a float64 mix,
the reference in float32.
"""

from __future__ import annotations

import importlib
import math
import sys

import numpy as np

from ..fields import params

COMPARED = ("u_err",)
CONTROL = {"float32": "tf32", "float64": "float32"}


def _kind(cell):
    return importlib.import_module(f"fem_bench.meshes.{cell.config['mesh']['kind']}")


def _base_load(cfg: dict):
    return importlib.import_module(f"fem_bench.loads.{cfg['load']}").at


def program(cell, inputs: dict, specs: dict, device, dtype):
    from ..forms import Forms

    basis = _kind(cell).port_basis(inputs, cell.config["element"], device, dtype)
    forms = Forms(specs["coefficient"], specs["load"], _base_load(cell.config), device, dtype)
    return basis, forms


def answer(cell, basis, u) -> np.ndarray:
    """``u`` at the input vertices, float64."""
    return u.reshape(-1).double().cpu().numpy()[_kind(cell).port_vertex_dofs(basis)]


def control_for(cell) -> str:
    return CONTROL[cell.traffic["dtype"]]


def compare(cell, inputs: dict, specs: dict, answers: list, seed: int, device,
            control: str | None = None):
    from ..reference import p1
    from ..work import reduced_nonzeros

    glued = importlib.import_module(f"fem_bench.reference.{cell.config['mesh']['kind']}").glue(inputs)
    ref = p1.Reference(glued, device, int(cell.config["element"]["quadrature_degree"]))
    base = _base_load(cell.config)
    worst, most = 0.0, 0
    for i, u in answers:
        p = params(specs, seed, i)
        fk, fg = (p1.field_function(specs[r], p[r], ref.device) for r in ("coefficient", "load"))

        def ff(x, fg=fg):
            return base(x)[..., 0] + fg(x)
        u_ref, iters = ref.solve(fk, ff)
        most = max(most, iters)
        u_ref = u_ref.cpu().numpy()[glued.vertex_node]
        if control is not None:
            u = ref.solve(fk, ff, control=control)[0].cpu().numpy()[glued.vertex_node]
        gap = float(np.abs(u - u_ref).max() / np.abs(u_ref).max())
        # a reference that did not converge judges nothing
        worst = math.nan if math.isnan(gap) or iters >= p1.MAXITER else max(worst, gap)
    print(f"reference: {len(answers)} solves, up to {most} CG iterations", file=sys.stderr)

    def work() -> dict:
        nnz, rows = reduced_nonzeros(glued.cells, glued.dirichlet)
        return {"nnz": nnz, "rows": rows}

    return {"u_err": worst if answers else math.nan}, work
