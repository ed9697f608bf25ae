"""PyTorch port, the edge bases and the traces onto them (``ElementLine``,
``InteriorEdgesBasis``, ``BoundaryEdgesBasis``, ``InteriorEdgesNetworkBasis``,
``InteriorEdgesFractureBasis``, the edge branches of ``Basis.interpolate``
and ``FractureBasis.interpolate``).

In float64 on the CPU, against the JAX package on the same inputs: a unit
square (n=8), the two-fracture network at h=0.3 and a two-fracture
``FracturesTri`` (``rectangle(8, 4)`` charts). Host tables byte-identical;
shape values, integration points and weights to 1e-12; the edge-length
functional; the traces of a linear function and the closed-form
normal-gradient jump; ``interpolate`` onto every edge basis in tensor and
callable form to 1e-12; the parameter gradient of a jump functional to
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_dfn
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.bench_vpinn import ANCHORS_2D, FRACTURES_3D

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]
CASES = ("interior", "boundary", "network", "fracture")


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


def _bc2(x):
    return x[..., 0:1] * (x[..., 0:1] - 1) * x[..., 1:2] * (x[..., 1:2] - 1)


@pytest.fixture(scope="module")
def setups():
    """case -> (JAX cell basis, JAX edge basis, port cell basis, port edge basis)."""
    out = {}
    jm = fem.MeshTri(fem.unit_square(n=8))
    pm = pt.MeshTri(pt.unit_square(n=8), device="cpu")
    jV, pV = fem.Basis(jm, fem.ElementTri(1, 2)), pt.Basis(pm, pt.ElementTri(1, 2))
    out["interior"] = (
        jV, fem.InteriorEdgesBasis(jm, fem.ElementLine(1, 2)),
        pV, pt.InteriorEdgesBasis(pm, pt.ElementLine(1, 2)),
    )
    out["boundary"] = (
        jV, fem.BoundaryEdgesBasis(jm, fem.ElementLine(1, 3)),
        pV, pt.BoundaryEdgesBasis(pm, pt.ElementLine(1, 3)),
    )
    jn = jax_dfn([F1, F2], h=0.3)
    pn = pt.build_fracture_network([F1, F2], h=0.3, device="cpu")
    out["network"] = (
        fem.FractureNetworkBasis(jn, fem.ElementTri(1, 2)),
        fem.InteriorEdgesNetworkBasis(jn, fem.ElementLine(1, 2)),
        pt.FractureNetworkBasis(pn, pt.ElementTri(1, 2)),
        pt.InteriorEdgesNetworkBasis(pn, pt.ElementLine(1, 2)),
    )
    tri = fem.rectangle(8, 4, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    jf = fem.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D)
    ptri = pt.rectangle(8, 4, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    pf = pt.FracturesTri([ptri, ptri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D, device="cpu")
    out["fracture"] = (
        fem.FractureBasis(jf, fem.ElementTri(1, 2)),
        fem.InteriorEdgesFractureBasis(jf, fem.ElementLine(1, 2)),
        pt.FractureBasis(pf, pt.ElementTri(1, 2)),
        pt.InteriorEdgesFractureBasis(pf, pt.ElementLine(1, 2)),
    )
    return out


@pytest.mark.parametrize("order", [1, 2, 3, 4])
def test_element_line_matches_jax(order):
    je, pe = fem.ElementLine(1, order), pt.ElementLine(1, order)
    np.testing.assert_array_equal(pe.gaussian_nodes.numpy(), np.asarray(je.gaussian_nodes))
    np.testing.assert_array_equal(
        pe.gaussian_weights.numpy().reshape(-1), np.asarray(je.gaussian_weights).reshape(-1)
    )
    assert pe.reference_element_area == je.reference_element_area == 2.0
    np.testing.assert_array_equal(pe.barycentric_grad.numpy(), np.asarray(je.barycentric_grad))
    rng = np.random.default_rng(order)
    x = rng.uniform(-1, 1, size=(5, 3, 1))
    bar = pe.compute_barycentric_coordinates(torch.tensor(x))
    assert _rel(bar.numpy(), je.compute_barycentric_coordinates(jnp.asarray(x))) <= 1e-15
    for d in (2, 3):
        jac = rng.standard_normal((7, d, 1))
        det, inv = pe.compute_det_and_inv_map(torch.tensor(jac))
        jdet, jinv = je.compute_det_and_inv_map(jnp.asarray(jac))
        assert _rel(det.numpy(), jdet) <= 1e-15 and _rel(inv.numpy(), jinv) <= 1e-15
        v, v_grad = pe.compute_shape_functions(bar[:, None], inv)
        jv, jv_grad = je.compute_shape_functions(jnp.asarray(bar.numpy())[:, None], jinv)
        assert _rel(v.numpy(), jv) == 0.0 and _rel(v_grad.numpy(), jv_grad) <= 1e-15
    # P2/P3 are ported (tests/test_torch_higher_order.py); P4 raises, as in
    # the JAX package
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementLine(4, order)


@pytest.mark.parametrize("case", CASES)
def test_edge_basis_host_tables_byte_identical(setups, case):
    _, jE, _, pE = setups[case]
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours, ref = getattr(pE, name), np.asarray(getattr(jE, name))
        assert ours.dtype == torch.int32, name
        np.testing.assert_array_equal(ours.numpy(), ref, err_msg=name)
    np.testing.assert_array_equal(pE._coords4global_dofs.numpy(), np.asarray(jE._coords4global_dofs))
    np.testing.assert_array_equal(pE._coords4elements.numpy(), np.asarray(jE._coords4elements))
    ours, ref = pE._basis_parameters, jE._basis_parameters
    assert sorted(ours) == sorted(ref)
    for key in ("bilinear_form_shape", "linear_form_shape", "nb_dofs"):
        assert tuple(np.atleast_1d(ours[key])) == tuple(np.atleast_1d(ref[key])), key
    for key in ("bilinear_form_idx", "linear_form_idx"):
        assert len(ours[key]) == len(ref[key])
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_array_equal(
        ours["inner_dofs"].numpy(), np.asarray(ref["inner_dofs"])
    )
    if case != "fracture":
        np.testing.assert_array_equal(
            pE._adjacent_cells().numpy(), np.asarray(jE._adjacent_cells())
        )
        assert pE._adjacent_cells().dtype == torch.int64


@pytest.mark.parametrize("case", CASES)
def test_edge_quadrature_matches_jax(setups, case):
    _, jE, _, pE = setups[case]
    for name in ("v", "v_grad", "integration_points", "_dx", "_inv_map_jacobian"):
        assert _rel(getattr(pE, name).numpy(), getattr(jE, name)) <= 1e-12, name


@pytest.mark.parametrize("case", ("interior", "boundary", "network"))
def test_edge_length_functional(setups, case):
    _, jE, _, pE = setups[case]
    ones = pE.integrate_functional(lambda b: torch.ones_like(b.integration_points[..., 0:1]))
    ref = jE.integrate_functional(lambda b: jnp.ones_like(b.integration_points[..., 0:1]))
    assert _rel(ones.numpy(), ref) <= 1e-12
    coords = pE._coords4global_dofs.numpy()[pE._global_dofs4elements.numpy()]
    lengths = np.linalg.norm(coords[:, 1] - coords[:, 0], axis=-1)
    assert abs(float(ones.sum()) - lengths.sum()) <= 1e-12 * lengths.sum()
    if case == "interior":
        expect = float(pE.mesh["interior_edges", "length"].sum())
        assert abs(float(ones.sum()) - expect) < 1e-13
    if case == "boundary":
        assert abs(float(ones.sum()) - 4.0) < 1e-13  # the unit square's perimeter


def test_two_sided_traces_of_linear_function(setups):
    _, jE, pV, pE = setups["interior"]
    coords = pV._coords4global_dofs.numpy()
    u = torch.tensor((2.0 * coords[:, 0] - 0.7 * coords[:, 1] + 0.3).reshape(-1, 1))
    vals, grads = pV.interpolate(pE, u)
    pts = pE.integration_points.numpy()  # (Ei, q, 1, 2)
    exact = 2.0 * pts[..., 0:1] - 0.7 * pts[..., 1:2] + 0.3
    assert vals.shape == (pE.mesh.n_interior_edges, 2, 2, 1, 1)
    for side in range(2):
        np.testing.assert_allclose(vals[:, side, :, 0].numpy(), exact[:, :, 0], atol=1e-12)
    np.testing.assert_allclose(grads[..., 0].numpy(), 2.0, atol=1e-12)
    np.testing.assert_allclose(grads[..., 1].numpy(), -0.7, atol=1e-12)
    normals = pE.mesh["interior_edges", "normals"][..., None, :, :]
    jump = (grads[:, 0] * normals).sum(-1) + (grads[:, 1] * -normals).sum(-1)
    np.testing.assert_allclose(jump.numpy(), 0.0, atol=1e-12)


def test_normal_gradient_jump_closed_form(setups):
    _, _, pV, pE = setups["interior"]
    mesh = pV.mesh
    u_np = np.random.default_rng(5).normal(size=(pV.n_dofs, 1))
    _, grads = pV.interpolate(pE, torch.tensor(u_np))
    grads = grads.numpy()  # (Ei, 2, 1, 1, 2)
    normals = mesh["interior_edges", "normals"].numpy()  # (Ei, 1, 2)
    jump = (grads[:, 0, 0] * normals).sum(-1) - (grads[:, 1, 0] * normals).sum(-1)
    verts = mesh["vertices", "coordinates"].numpy()
    tris = mesh["cells", "vertices"].numpy()
    p = verts[tris]
    J = np.stack([p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]], axis=2)
    G = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]) @ np.linalg.inv(J)
    cell_grad = (u_np[tris, 0][..., None] * G).sum(1)
    cells = mesh["interior_edges", "cells"].numpy()
    oracle = ((cell_grad[cells[:, 0]] - cell_grad[cells[:, 1]]) * normals[:, 0]).sum(-1)
    np.testing.assert_allclose(jump[:, 0], oracle, atol=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_interpolate_tensor_matches_jax(setups, case):
    jV, jE, pV, pE = setups[case]
    u = np.random.default_rng(7).standard_normal((pV.n_dofs, 1))
    vals, grads = pV.interpolate(pE, torch.tensor(u))
    jvals, jgrads = jax.jit(lambda x: jV.interpolate(jE, x))(jnp.asarray(u))
    assert _rel(vals.numpy(), jvals) <= 1e-12
    assert _rel(grads.numpy(), jgrads) <= 1e-12
    if case == "boundary":
        assert vals.shape[1] == 1  # one-sided
    # the basis onto itself is unchanged by the edge branches
    svals, sgrads = pV.interpolate(pV, torch.tensor(u))
    jsvals, jsgrads = jax.jit(lambda x: jV.interpolate(jV, x))(jnp.asarray(u))
    assert _rel(svals.numpy(), jsvals) <= 1e-12 and _rel(sgrads.numpy(), jsgrads) <= 1e-12


@pytest.mark.parametrize("case", CASES)
def test_interpolate_callable_matches_jax(setups, case):
    jV, jE, pV, pE = setups[case]
    d = pV._coords4global_dofs.shape[-1]
    coef = np.random.default_rng(11).standard_normal(d)

    def f(pkg):
        c = torch.tensor(coef) if pkg is pt else jnp.asarray(coef)
        if pkg is pt:
            return lambda x: torch.sin((x * c).sum(-1, keepdim=True))
        return lambda x: jnp.sin((x * c).sum(-1, keepdims=True))

    for target_p, target_j in ((pE, jE), (pV, jV)):
        interp, interp_grad = pV.interpolate(target_p)
        ref, ref_grad = jV.interpolate(target_j)
        want, want_grad = jax.jit(lambda: (ref(f(fem)), ref_grad(f(fem))))()
        assert _rel(interp(f(pt)).numpy(), want) <= 1e-12
        assert _rel(interp_grad(f(pt)).numpy(), want_grad) <= 1e-12


def test_batched_edge_forms_match_jax(setups):
    """The fracture edge basis's batched assembly layout (a leading fracture
    axis in every shape and a batch index in every scatter)."""
    _, jE, _, pE = setups["fracture"]
    jlin, jbil, jred = jax.jit(lambda: (
        jE.integrate_linear_form(lambda b: b.v * b.integration_points[..., 1:2]),
        jE.integrate_bilinear_form(lambda b: b.v @ jnp.matrix_transpose(b.v)),
        jE.reduce(jE.integrate_linear_form(lambda b: b.v * b.integration_points[..., 1:2])),
    ))()
    lin = pE.integrate_linear_form(lambda b: b.v * b.integration_points[..., 1:2])
    assert lin.shape == (2, pE.n_dofs, 1) and _rel(lin.numpy(), jlin) <= 1e-12
    bil = pE.integrate_bilinear_form(lambda b: b.v @ b.v.mT)
    assert bil.shape == (2, pE.n_dofs, pE.n_dofs) and _rel(bil.numpy(), jbil) <= 1e-12
    assert _rel(pE.reduce(lin).numpy(), jred) <= 1e-12


def _jump_functional(pkg, V, E, net):
    """``sum_E h_E [grad u . n]^2`` of the network's nodal interpolant
    (``examples/common.py:make_edge_jump``)."""
    _, interp_grad = V.interpolate(E)
    h_E = V.mesh["interior_edges", "length"][..., None, :, :]
    n_E = V.mesh["interior_edges", "normals"][..., None, :, :]
    kw = {"keepdim": True} if pkg is pt else {"keepdims": True}

    def jump(_):
        g = interp_grad(net)
        return h_E * ((g[:, 0] * n_E).sum(-1, **kw) + (g[:, 1] * -n_E).sum(-1, **kw)) ** 2

    return E.integrate_functional(jump).sum()


def test_jump_functional_gradient_matches_jax(setups):
    jV, jE, pV, pE = setups["interior"]
    jnet = fem.FeedForwardNeuralNetwork(2, 1, 2, 8, boundary_condition_modifier=_bc2, seed=3)
    # a different seed for the port's own draw: the weights come across
    pnet = interop.network_from_numpy(
        [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases],
        input_dimension=2, output_dimension=1, nb_hidden_layers=2, neurons_per_layers=8,
        boundary_condition_modifier=_bc2, seed=4, device="cpu", dtype=torch.float64,
    )
    for w, jw in zip(pnet.weights, jnet.weights):
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jw))
    value, grads = jax.jit(jax.value_and_grad(lambda n: _jump_functional(fem, jV, jE, n)))(jnet)
    loss = _jump_functional(pt, pV, pE, pnet)
    loss.backward()
    assert float(value) > 0
    assert abs(float(loss.detach()) - float(value)) <= 1e-12 * float(value)
    params = dict(pnet.named_parameters())
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad.numpy(), w) <= 1e-10
        assert _rel(params[f"b{i}"].grad.numpy(), b) <= 1e-10
