"""PyTorch port, adaptive refinement (``mesh/refinement.py``: ``dorfler_mark``,
``refine_adaptive``, ``refine_network_adaptive``; ``MeshTri.refined`` and
``FractureNetworkMesh.refined``).

On the CPU, against the JAX package on the same inputs: Dörfler marks on
seeded indicators with deliberate ties byte-identical; three rounds of
``refine_adaptive`` / ``MeshTri.refined`` on ``unit_square(n=8)`` with
seeded marks, every table byte-identical; three rounds of
``refine_network_adaptive`` / ``FractureNetworkMesh.refined`` on the
two-fracture network at h=0.3 with one-sided marking (all of fracture 0,
as ``tests/test_dfn.py`` does), every table byte-identical and the trace
subdivisions identical in both fractures, then ``solve_iterative`` on the
refined network with the JAX iteration count and the solution to 1e-12.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh import refinement as jax_refinement
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_dfn
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.mesh import refinement

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _assert_tables_identical(pmesh, jmesh):
    keys = sorted(key for key, _ in _leaves(jmesh._t))
    assert keys == sorted(key for key, _ in _leaves(pmesh._t))
    for key, ref in _leaves(jmesh._t):
        ref, ours = np.asarray(ref), pmesh[key]
        assert ours.dtype == (torch.float64 if ref.dtype.kind == "f" else torch.int32), key
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=str(key))


def _assert_dicts_identical(ours, ref):
    assert sorted(ours) == sorted(ref)
    for key in ref:
        a, b = np.asarray(ours[key]), np.asarray(ref[key])
        assert a.dtype == b.dtype and a.shape == b.shape, key
        np.testing.assert_array_equal(a, b, err_msg=key)


@pytest.mark.parametrize("theta", [0.05, 0.3, 0.5, 0.8, 1.0])
def test_dorfler_mark_with_ties_byte_identical(theta):
    rng = np.random.default_rng(17)
    # few distinct values, so most cells tie with others, the threshold
    # cell included
    eta = rng.integers(1, 6, size=400) / 7.0
    eta[::9] = eta[0]
    ref = jax_refinement.dorfler_mark(eta, theta)
    ours = pt.dorfler_mark(eta, theta)
    assert ours.dtype == np.bool_
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(pt.dorfler_mark(torch.tensor(eta), theta), ref)
    np.testing.assert_array_equal(
        pt.dorfler_mark(eta.astype(np.float32), theta),
        jax_refinement.dorfler_mark(jnp.asarray(eta.astype(np.float32)), theta),
    )
    held = (eta[ref] ** 2).sum()
    assert held >= theta * (eta**2).sum() * (1 - 1e-12)


def test_refine_adaptive_three_rounds_byte_identical():
    jm = fem.MeshTri(fem.unit_square(n=8))
    pm = pt.MeshTri(pt.unit_square(n=8), device="cpu")
    _assert_tables_identical(pm, jm)
    rng = np.random.default_rng(3)
    for step in range(3):
        marked = rng.random(pm.n_cells) < 0.15
        ours = refinement.refine_adaptive(
            {"vertices": pm["vertices", "coordinates"].numpy(),
             "triangles": pm["cells", "vertices"].numpy(),
             "vertex_markers": pm["vertices", "markers"].numpy()},
            marked,
        )
        ref = jax_refinement.refine_adaptive(
            {"vertices": np.asarray(jm["vertices", "coordinates"]),
             "triangles": np.asarray(jm["cells", "vertices"]),
             "vertex_markers": np.asarray(jm["vertices", "markers"])},
            marked,
        )
        _assert_dicts_identical(ours, ref)
        n_before = pm.n_cells
        pm, jm = pm.refined(torch.tensor(marked)), jm.refined(marked)
        assert pm.n_cells > n_before and pm.device.type == "cpu"
        _assert_tables_identical(pm, jm)
    # boundary midpoints inherit their endpoints' label
    assert (pm["vertices", "markers"].numpy() != 0).sum() > 4 * 8


def test_refined_keeps_device_and_dtype_and_refuses_bad_input():
    pm = pt.MeshTri(pt.unit_square(n=4), device="cpu", dtype=torch.float32)
    fine = pm.refined(np.ones(pm.n_cells, dtype=bool))
    assert fine.dtype == torch.float32 and fine["cells", "vertices"].dtype == torch.int32
    assert fine.n_cells >= 2 * pm.n_cells
    with pytest.raises(ValueError, match="entries"):
        pm.refined(np.ones(pm.n_cells + 1, dtype=bool))
    same = pm.refined(np.zeros(pm.n_cells, dtype=bool))
    assert torch.equal(same["cells", "vertices"], pm["cells", "vertices"])
    # a network built from its tables alone has no host sources
    jn = jax_dfn([F1, F2], h=0.5)
    tables = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jn._t), device="cpu")
    with pytest.raises(ValueError, match="host-side"):
        tables.refined(np.zeros(tables.n_cells, dtype=bool))


def _trace_edge_sets(gids, cells, fracture, coords):
    """Per fracture, the set of its edges lying on the trace x = z = 0,
    as sorted global vertex pairs (``tests/test_dfn.py``)."""
    sets = {}
    for f in np.unique(fracture):
        edges = np.sort(gids[cells[fracture == f][:, [[0, 1], [1, 2], [2, 0]]].reshape(-1, 2)], axis=1)
        p = coords[edges]
        on_trace = (np.abs(p[..., 0]) < 1e-9).all(axis=1) & (np.abs(p[..., 2]) < 1e-9).all(axis=1)
        sets[int(f)] = set(map(tuple, edges[on_trace]))
    return sets


def _stiffness(b):
    if isinstance(b.v_grad, torch.Tensor):
        return b.v_grad @ b.v_grad.mT
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def test_network_one_sided_refinement_three_rounds():
    jm = jax_dfn([F1, F2], h=0.3)
    pm = pt.build_fracture_network([F1, F2], h=0.3, device="cpu")
    _assert_tables_identical(pm, jm)
    for step in range(3):
        marked = pm["cells", "fracture"].numpy().reshape(-1) == 0
        ours = refinement.refine_network_adaptive(pm._sources["triangulations"], pm, marked)
        ref = jax_refinement.refine_network_adaptive(jm._sources["triangulations"], jm, marked)
        assert len(ours) == len(ref) == 2
        for a, b in zip(ours, ref):
            _assert_dicts_identical(a, b)
        pm, jm = pm.refined(marked), jm.refined(marked)
        _assert_tables_identical(pm, jm)
        sets = _trace_edge_sets(
            pm["global", "ids"].numpy().reshape(-1), pm["cells", "vertices"].numpy(),
            pm["cells", "fracture"].numpy().reshape(-1), pm["global", "vertices_3d"].numpy(),
        )
        assert sets[0] == sets[1] and len(sets[0]) > 0, f"trace subdivisions diverged at step {step}"
    counts = np.bincount(pm["cells", "fracture"].numpy().reshape(-1))
    assert counts[0] > 64 and counts[1] > 64  # conformity forced growth in fracture 1

    jV = fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2))
    pV = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    u_ref, info_ref = jV.solve_iterative(
        jV.integrate_bilinear_form_local(_stiffness), jV.integrate_linear_form(lambda b: b.v),
        tol=1e-10, symmetric_form=True, return_info=True,
    )
    u, info = pV.solve_iterative(
        pV.integrate_bilinear_form_local(_stiffness), pV.integrate_linear_form(lambda b: b.v),
        tol=1e-10, symmetric_form=True, return_info=True,
    )
    assert info.iterations == int(info_ref.iterations)
    u_ref = np.asarray(u_ref)
    assert np.abs(u.numpy() - u_ref).max() <= 1e-12 * np.abs(u_ref).max()
