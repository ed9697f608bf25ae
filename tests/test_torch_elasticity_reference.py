"""The plain reference of the benchmark's elasticity problem
(``fem_bench/reference/elasticity_p1.py``) and the port's vector solve
against it, float64 on the CPU.

The reference's stiffness without boundary conditions annihilates the six
rigid-body modes; with E = 1 its error against the closed-form bubble
u = b(x) (1, 2, -1), b = x(1-x) y(1-y) z(1-z), falls by about 4 from
``kuhn_cube(4)`` to ``kuhn_cube(8)`` (3.3 there, 3.8 from 8 to 16: P1's
h^2); and the port's ``VectorBasis`` ``compiled_solver`` with the
rigid-body-mode M (``precondition="auto"``), driven through the problem
module's forms, matches it to 1e-9 on ``kuhn_cube(4)`` and ``(6)`` for
three seeded log-normal E fields.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from fem_bench import fields, problems
from fem_bench.entries import compiled_solver
from fem_bench.meshes.kuhn_cube import kuhn_cube
from fem_bench.reference.elasticity_p1 import Reference, lame
from fem_bench.reference.kuhn_cube import glue
from fem_bench.reference.p1 import Glued
from fem_bench.run import Cell

REPO = Path(__file__).resolve().parents[1]
W = torch.tensor([1.0, 2.0, -1.0], dtype=torch.float64)
SEEDS = (3, 2**31 + 11, 2**40 + 5)


def _mesh(n):
    v, t = kuhn_cube(n)
    return {"vertices": v, "tetrahedra": t}


def rigid_body_modes(points: torch.Tensor) -> torch.Tensor:
    """The six rigid-body displacements at ``points`` (N, 3), as (6, N, 3):
    three translations and the rotations about the three axes."""
    z = torch.zeros_like(points[:, 0])
    one = torch.ones_like(z)
    x0, x1, x2 = points.unbind(-1)
    return torch.stack([
        torch.stack([one, z, z], -1), torch.stack([z, one, z], -1), torch.stack([z, z, one], -1),
        torch.stack([z, -x2, x1], -1), torch.stack([x2, z, -x0], -1),
        torch.stack([-x1, x0, z], -1),
    ])


def test_unconstrained_stiffness_annihilates_rigid_body_modes():
    inp = _mesh(3)
    g = glue(inp)
    free = Glued(g.cell_coords, g.cells, np.zeros(len(inp["vertices"]), dtype=bool),
                 g.vertex_node)
    ref = Reference(free, "cpu")
    values, _ = ref.assemble(lambda x: torch.exp(torch.sin(3.0 * x[..., 0]) * x[..., 2]),
                             lambda x: torch.zeros_like(x))
    K = ref.matrix(values)
    modes = rigid_body_modes(torch.as_tensor(inp["vertices"]))
    assert modes.shape == (6, len(inp["vertices"]), 3)
    for r in modes:
        assert float((K @ r.reshape(-1)).norm() / (values.norm() * r.norm())) <= 1e-10
    # and it is no zero matrix: a stretch is not annihilated
    x = torch.as_tensor(inp["vertices"])
    stretch = torch.stack([x[:, 0], torch.zeros_like(x[:, 0]), torch.zeros_like(x[:, 0])], -1)
    assert float((K @ stretch.reshape(-1)).norm() / (values.norm() * stretch.norm())) > 1e-3


def _bubble_load(mu, lam):
    """f = -mu lap(u) - (mu + lambda) grad div u of u = b(x) W."""

    def p(t):
        return t * (1.0 - t)

    def f(x):
        P = [p(x[..., i]) for i in range(3)]
        D = [1.0 - 2.0 * x[..., i] for i in range(3)]
        H = torch.empty(x.shape[:-1] + (3, 3), dtype=x.dtype, device=x.device)  # Hessian of b
        for i in range(3):
            for j in range(3):
                k = 3 - i - j
                H[..., i, j] = (-2.0 * P[(i + 1) % 3] * P[(i + 2) % 3] if i == j
                                else D[i] * D[j] * P[k])
        lap = H.diagonal(dim1=-2, dim2=-1).sum(-1)
        return -mu * lap[..., None] * W - (mu + lam) * (H @ W)

    return f


def test_reference_converges_on_the_bubble():
    f = _bubble_load(*lame(0.3))
    errors = []
    for n in (4, 8):
        inp = _mesh(n)
        ref = Reference(glue(inp), "cpu")
        u, iters = ref.solve(lambda x: torch.ones(x.shape[:-1], dtype=x.dtype), f)
        x = torch.as_tensor(inp["vertices"])
        exact = (x[:, 0] * (1 - x[:, 0]) * x[:, 1] * (1 - x[:, 1]) * x[:, 2] * (1 - x[:, 2]))[
            :, None] * W
        assert iters < 1000
        errors.append(float((u - exact).abs().max() / exact.abs().max()))
    assert errors[0] < 0.2
    assert 3.0 < errors[0] / errors[1] < 5.0, errors


@pytest.fixture(scope="module")
def traffic():
    t = json.loads((REPO / "fem_bench/traffic/mc_lognormal.json").read_text())
    t.update(dtype="float64", keywords={"tol": 1e-12, "precondition": "auto"})
    return t


@pytest.mark.parametrize("n", [4, 6])
def test_port_matches_reference(traffic, n):
    config = json.loads((REPO / "fem_bench/configs/cube64_elast_p1.json").read_text())
    config["mesh"] = dict(config["mesh"], n=n)
    cell = Cell("cube_elast.test", config, traffic, {}, [], [])
    problem = problems.of(config)
    assert problem.__name__ == "fem_bench.problems.elasticity_p1"
    inputs = _mesh(n)
    specs = {r: fields.field_spec(traffic[r], 1.0) for r in fields.STREAMS}
    basis, forms = problem.program(cell, inputs, specs, "cpu", torch.float64)
    assert basis.n_components == 3
    request = compiled_solver.build(basis, forms, traffic["keywords"])
    for seed in SEEDS:
        p = fields.params(specs, seed, 0)
        forms.set(p["coefficient"], p["load"])
        u, iterations, converged = request()
        assert bool(converged) and 0 < int(iterations) < 200
        answer = problem.answer(cell, basis, u)
        assert answer.shape == ((n + 1) ** 3, 3)
        numbers, _ = problem.compare(cell, inputs, specs, [(0, answer)], seed, "cpu")
        assert numbers["u_err"] <= 1e-9, (seed, numbers)
