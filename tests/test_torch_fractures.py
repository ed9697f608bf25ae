"""PyTorch port, the two-fracture RVPINN path (``FracturesTri``,
``build_global_triangulation``, P1 ``FractureBasis``) against the JAX
package's ``__graft_entry__._build_problem`` at n=4, in float64 on the CPU:
the glue tables byte-identical, the basis values to 1e-13, and the entry's
RVPINN loss and its parameter gradients to 1e-10.
"""

import importlib.util
import pathlib

import jax
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.basis import build_global_triangulation
from pytorch_fem_solver_tpu_torch.bench_vpinn import (
    ANCHORS_2D,
    FRACTURES_3D,
    make_two_fracture,
    two_fracture_loss,
)

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REPO = pathlib.Path(__file__).resolve().parent.parent


def _graft_entry():
    spec = importlib.util.spec_from_file_location("graft_entry", REPO / "__graft_entry__.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def problems():
    _, jmesh, jV, jnet, jloss, _, _ = _graft_entry()._build_problem(4)
    port = make_two_fracture(4, device="cpu")
    return (jmesh, jV, jnet, jloss), port


def _leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


def test_fractures_mesh_matches_jax(problems):
    (jmesh, _, _, _), port = problems
    keys = [key for key, _ in _leaves(jmesh._t)]
    assert sorted(keys) == sorted(key for key, _ in _leaves(port.mesh._t))
    for key, ref in _leaves(jmesh._t):
        ours = port.mesh[key]
        ref = np.asarray(ref)
        if np.issubdtype(ref.dtype, np.floating):
            assert ours.dtype == torch.float64
            assert _rel(ours.numpy(), ref) <= 1e-13, key
        else:
            assert ours.dtype == torch.int32
            np.testing.assert_array_equal(ours.numpy(), ref, err_msg=str(key))
    assert port.mesh.batch_size() == (2,)


def test_global_triangulation_tables_byte_identical(problems):
    (jmesh, jV, _, _), port = problems
    ref = jV.global_triangulation
    ours = port.basis.global_triangulation
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        value = np.asarray(value)
        if np.issubdtype(value.dtype, np.floating):
            np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
        else:
            assert ours[key].dtype == torch.int32
            np.testing.assert_array_equal(ours[key].numpy(), value, err_msg=key)
    # the charts share the trace x = z = 0, 0 <= y <= 1: n + 1 = 5 vertices
    assert ours["traces_global_vertices_idx"].numel() == 5
    again = build_global_triangulation(port.mesh)
    for key in ours:
        assert torch.equal(again[key], ours[key])


def test_fracture_basis_values_match_jax(problems):
    (_, jV, _, _), port = problems
    V = port.basis
    for name in ("v", "v_grad", "_dx", "integration_points", "_inv_map_jacobian"):
        assert _rel(getattr(V, name).numpy(), getattr(jV, name)) <= 1e-13, name
    np.testing.assert_array_equal(V._global_dofs4elements.numpy(), np.asarray(jV._global_dofs4elements))
    np.testing.assert_array_equal(
        V._basis_parameters["inner_dofs"].numpy(), np.asarray(jV._basis_parameters["inner_dofs"])
    )
    assert V.n_dofs == jV.n_dofs


def test_two_fracture_loss_and_gradients_match_jax(problems):
    (_, jV, jnet, jloss), port = problems
    loss_ref, grads = jax.value_and_grad(jloss)(jnet, jV)
    loss = two_fracture_loss(port.network, port.basis)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-10 * float(loss_ref)
    params = dict(port.network.named_parameters())
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad.numpy(), w) <= 1e-10
        assert _rel(params[f"b{i}"].grad.numpy(), b) <= 1e-10


def test_collinear_anchors_raise():
    tri = pt.rectangle(4, 2, x0=-1.0, x1=1.0)
    # default anchors: the first three mesh vertices, collinear on y = 0
    with pytest.raises(ValueError, match="collinear"):
        pt.FracturesTri([tri, tri], FRACTURES_3D, device="cpu")
    bad = ANCHORS_2D.copy()
    bad[1] = [[0.0, 0.0], [0.5, 0.0], [1.0, 0.0]]
    with pytest.raises(ValueError, match="fracture 1"):
        pt.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=bad, device="cpu")


def test_unported_parts_raise(problems):
    (_, jV, _, _), port = problems
    # FractureBasis.interpolate onto itself is ported: values and gradients
    # of a global DOF vector equal JAX's
    u = np.random.default_rng(2).standard_normal((port.basis.n_dofs, 1))
    vals, grads = port.basis.interpolate(port.basis, torch.tensor(u))
    ref_vals, ref_grads = jV.interpolate(jV, jax.numpy.asarray(u))
    assert _rel(vals.numpy(), ref_vals) <= 1e-13
    assert _rel(grads.numpy(), ref_grads) <= 1e-13
    # P2/P3 are ported (tests/test_torch_higher_order.py); P4 raises, as in
    # the JAX package
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementTri(4, 2)
