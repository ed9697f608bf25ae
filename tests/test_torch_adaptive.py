"""PyTorch port, the adaptive DFN loop (``bench.adaptive_dfn``).

In float64 on the CPU, against ``examples/example_adaptive_dfn.py:
solve_and_estimate`` of the JAX package on the two-fracture network at
h=0.3 for 3 levels of ``bench.adaptive_dfn`` (Dörfler marking at theta
0.5, then ``FractureNetworkMesh.refined``): per level the cells, DOFs and PCG
iterations equal, the mesh tables byte-identical, the energy and the
per-cell ``eta`` to 1e-10; the marks of both packages' ``dorfler_mark`` on
JAX's ``eta`` byte-identical, and equal to the port's marks on its own
``eta``, which drive the loop. The JAX levels are independent once their
meshes are known, so they run side by side in threads (each level's first
call compiles a few hundred XLA programs).
"""

import importlib.util
import pathlib
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_dfn
from pytorch_fem_solver_tpu.mesh.refinement import dorfler_mark as jax_dorfler
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench import adaptive_dfn

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]
THETA = 0.5
LEVELS = 3


def _example():
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(
        "example_adaptive_dfn", EXAMPLES / "example_adaptive_dfn.py"
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def test_adaptive_dfn_loop_matches_jax():
    example = _example()

    def jax_level(mesh):
        """The example's (n_dofs, energy, eta) and its PCG iteration count
        (the same solve once more, with ``return_info``)."""
        n, energy, eta = example.solve_and_estimate(mesh)
        V = fem.FractureNetworkBasis(mesh, fem.ElementTri(1, 2))
        _, info = V.solve_iterative(
            V.integrate_bilinear_form_local(example.a_form), V.integrate_linear_form(example.l_form),
            tol=1e-10, precondition="two_level", symmetric_form=True, return_info=True,
        )
        return n, energy, eta, int(info.iterations)

    pmesh = pt.build_fracture_network([F1, F2], h=0.3, device="cpu")
    levels = list(adaptive_dfn(pmesh, LEVELS, THETA, tol=1e-10))
    # the marks the loop refined by, and the JAX meshes refined by them
    marks = [pt.dorfler_mark(lv.eta, THETA) for lv in levels[:-1]]
    jmeshes = [jax_dfn([F1, F2], h=0.3)]
    for marked in marks:
        jmeshes.append(jmeshes[-1].refined(marked))
    with ThreadPoolExecutor(LEVELS) as pool:
        refs = list(pool.map(jax_level, jmeshes))

    for level, (lv, jmesh, (n, energy, eta, iterations)) in enumerate(zip(levels, jmeshes, refs)):
        for key in (("cells", "vertices"), ("global", "ids"), ("interior_edges", "cells")):
            np.testing.assert_array_equal(lv.mesh[key].numpy(), np.asarray(jmesh[key]), err_msg=str(key))
        assert lv.mesh.n_cells == jmesh.n_cells and lv.n_dofs == n
        assert lv.info.iterations == iterations, level
        assert bool(lv.info.converged)
        assert abs(lv.energy - energy) <= 1e-10 * abs(energy)
        assert lv.eta.dtype == np.float64 and _rel(lv.eta, eta) <= 1e-10
        jax_marks = jax_dorfler(eta, THETA)
        np.testing.assert_array_equal(pt.dorfler_mark(eta, THETA), jax_marks)
        if level + 1 < LEVELS:
            # the loop ran on the port's own marks: they must be JAX's, or
            # a tie at the threshold ordered by a 1e-16 gap forked the meshes
            differ = np.flatnonzero(marks[level] != jax_marks)
            assert differ.size == 0, (
                f"level {level}: the port's own marks differ from JAX's at cells "
                f"{differ.tolist()}, eta gap {np.abs(lv.eta - eta)[differ].max():.3e}"
            )
    cells = [lv.mesh.n_cells for lv in levels]
    assert cells[0] < cells[1] < cells[2]
    assert levels[0].seconds["refine"] == 0.0 and levels[1].seconds["refine"] > 0.0
