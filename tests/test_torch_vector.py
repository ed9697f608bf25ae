"""PyTorch port, ``VectorBasis`` against the JAX package in float64.

The interleaved DOF lift (node i, component c) -> i * nc + c is built on
the host in NumPy int64 in both packages, so the DOF map, the boundary
markers, the DOF coordinates and the interior-DOF list are byte-identical
on P1-P3 triangles and P1 tets, with every component clamped and with the
roller ``dirichlet_components=(1,)``. The lifted ``v`` (q, n_vloc, nc) and
``v_grad`` (T, 1|q, n_vloc, nc, d), the assembled elasticity operator, the
load, self-interpolation and the dense solve agree to 1e-12 relative; the
validation raises carry the JAX package's types and texts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

MU, LAM = 1.0, 1.5
REL = 1e-12


def _rel(ours, ref) -> float:
    ref = np.asarray(ref)
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300))


def elasticity(b):
    """The Lamé form, written for either package."""
    g = b.v_grad
    if isinstance(g, torch.Tensor):
        eps = 0.5 * (g + g.transpose(-1, -2))
        div = g.diagonal(dim1=-2, dim2=-1).sum(-1)
        dot = torch.einsum("...icd,...jcd->...ij", eps, eps)
    else:
        eps = 0.5 * (g + jnp.swapaxes(g, -1, -2))
        div = jnp.trace(g, axis1=-2, axis2=-1)
        dot = jnp.einsum("...icd,...jcd->...ij", eps, eps)
    return 2 * MU * dot + LAM * div[..., :, None] * div[..., None, :]


def load(b):
    """A smooth body force (sin 3x, cos 2y[, z^2]) against the vector shape
    functions."""
    p = b.integration_points[..., 0, :]  # (T, q, d)
    m = torch if isinstance(p, torch.Tensor) else jnp
    cols = [m.sin(3 * p[..., 0]), m.cos(2 * p[..., 1])]
    if p.shape[-1] == 3:
        cols.append(p[..., 2] ** 2)
    return (b.v * m.stack(cols, -1)[..., None, :]).sum(-1)[..., None]


CASES = {
    "tri-P1": ("tri", 1, 4),
    "tri-P2": ("tri", 2, 4),
    "tri-P3": ("tri", 3, 5),
    "tet-P1": ("tet", 1, 2),
}


def _pair(kind, order, quad, dirichlet_components=None, n=None):
    if kind == "tri":
        n = n or 3
        jm, pm = fem.MeshTri(fem.unit_square(n=n)), pt.MeshTri(pt.unit_square(n=n), device="cpu")
        je, pe = fem.ElementTri(order, quad), pt.ElementTri(order, quad)
    else:
        n = n or 2
        jm, pm = fem.MeshTet(fem.unit_cube(n)), pt.MeshTet(pt.unit_cube(n), device="cpu")
        je, pe = fem.ElementTet(order, quad), pt.ElementTet(order, quad)
    return (
        fem.VectorBasis(jm, je, dirichlet_components=dirichlet_components),
        pt.VectorBasis(pm, pe, dirichlet_components=dirichlet_components),
    )


@pytest.mark.parametrize("dirichlet_components", [None, (1,)], ids=["clamped", "roller"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_byte_identical_and_shape_tables(case, dirichlet_components):
    kind, order, quad = CASES[case]
    jV, pV = _pair(kind, order, quad, dirichlet_components)
    assert pV.n_components == jV.n_components == (2 if kind == "tri" else 3)
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs", "_coords4global_dofs"):
        ref, ours = np.asarray(getattr(jV, name)), getattr(pV, name).numpy()
        assert ours.dtype == ref.dtype and ours.shape == ref.shape, name
        assert ours.tobytes() == ref.tobytes(), name
    ref = np.asarray(jV._basis_parameters["inner_dofs"])
    ours = pV._basis_parameters["inner_dofs"].numpy()
    assert ours.dtype == ref.dtype and ours.tobytes() == ref.tobytes()
    for key in ("bilinear_form_idx", "linear_form_idx"):
        for a, b in zip(jV._basis_parameters[key], pV._basis_parameters[key]):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert pV.n_dofs == jV.n_dofs
    nc, n_vloc = pV.n_components, pV._global_dofs4elements.shape[-1]
    q = pV.v.shape[0]
    assert pV.v.shape == (q, n_vloc, nc)
    assert pV.v_grad.shape[2:] == (n_vloc, nc, nc)
    assert pV.v_grad.shape[1] in (1, q)
    assert _rel(pV.v, jV.v) <= REL
    assert _rel(pV.v_grad, jV.v_grad) <= REL


@pytest.mark.parametrize("case", ["tri-P1", "tri-P2", "tet-P1"])
def test_forms_interpolate_and_dense_solve_match_jax(case):
    kind, order, quad = CASES[case]
    jV, pV = _pair(kind, order, quad, n=4 if kind == "tri" else 2)
    A_ref = jV.integrate_bilinear_form(elasticity)
    A = pV.integrate_bilinear_form(elasticity)
    assert _rel(A, A_ref) <= REL
    assert float((A - A.T).abs().max()) <= 1e-14 * float(A.abs().max())
    b_ref = jV.integrate_linear_form(load)
    b = pV.integrate_linear_form(load)
    assert _rel(b, b_ref) <= REL
    u_ref = jV.solve(A_ref, jV.solution_tensor(), b_ref)
    u = pV.solve(A, pV.solution_tensor(), b)
    assert _rel(u, u_ref) <= 1e-10
    w = np.random.default_rng(7).standard_normal((pV.n_dofs, 1))
    (uh, ugh), (uh_ref, ugh_ref) = pV.interpolate(pV, torch.from_numpy(w)), jV.interpolate(
        jV, jnp.asarray(w)
    )
    nc, d = pV.n_components, pV.v_grad.shape[-1]
    assert uh.shape[-2:] == (1, nc) and ugh.shape[-3:] == (1, nc, d)
    assert _rel(uh, uh_ref) <= REL and _rel(ugh, ugh_ref) <= REL


def test_interpolation_reproduces_a_linear_field():
    """The patch test of the JAX package's ``tests/test_elasticity.py``:
    P1 vector interpolation is exact on an affine displacement."""
    _, pV = _pair("tri", 1, 2)
    G = np.array([[0.3, -0.2], [0.1, 0.4]])
    c = np.array([0.05, -0.07])
    nodes = pV._coords4global_dofs.numpy()
    comp = np.arange(pV.n_dofs) % 2
    u = (nodes @ G.T)[np.arange(pV.n_dofs), comp] + c[comp]
    uh, ugh = pV.interpolate(pV, torch.from_numpy(u.reshape(-1, 1)))
    pts = pV.integration_points.numpy()[..., 0, :]
    np.testing.assert_allclose(uh.numpy()[..., 0, :], pts @ G.T + c, atol=1e-13)
    np.testing.assert_allclose(ugh.numpy()[..., 0, :, :], np.broadcast_to(G, ugh.shape[:2] + G.shape),
                               atol=1e-13)


def test_roller_frees_the_unclamped_component():
    jV, pV = _pair("tri", 1, 2, (1,), n=4)
    full = pt.VectorBasis(pt.MeshTri(pt.unit_square(n=4), device="cpu"), pt.ElementTri(1, 2))
    marks = pV.mesh["vertices", "markers"].numpy().reshape(-1)
    n_nodes, n_bnd = marks.size, int((marks == 1).sum())
    assert full._basis_parameters["inner_dofs"].numel() == 2 * (n_nodes - n_bnd)
    inner = set(pV._basis_parameters["inner_dofs"].tolist())
    assert len(inner) == 2 * n_nodes - n_bnd and set(range(0, 2 * n_nodes, 2)) <= inner


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


def test_validation_raises_as_jax():
    jm, pm = fem.MeshTri(fem.unit_square(n=2)), pt.MeshTri(pt.unit_square(n=2), device="cpu")
    je, pe = fem.ElementTri(1, 2), pt.ElementTri(1, 2)
    for kwargs in ({"n_components": 0}, {"dirichlet_components": (5,)},
                   {"n_components": 3, "dirichlet_components": (0, 3, -1)}):
        ref = _raised(lambda: fem.VectorBasis(jm, je, **kwargs))
        assert ref[0] is ValueError
        assert _raised(lambda: pt.VectorBasis(pm, pe, **kwargs)) == ref
    jV, pV = fem.VectorBasis(jm, je), pt.VectorBasis(pm, pe)
    ref = _raised(lambda: jV.interpolate(fem.Basis(jm, je), None))
    assert ref[0] is NotImplementedError
    assert _raised(lambda: pV.interpolate(pt.Basis(pm, pe), None)) == ref
    ref = _raised(lambda: jV.interpolate(jV))
    assert ref[0] is NotImplementedError
    assert _raised(lambda: pV.interpolate(pV)) == ref


def test_vector_basis_is_exported():
    assert pt.VectorBasis is pt.basis.VectorBasis
    assert "VectorBasis" in pt.__all__ and "VectorBasis" in pt.basis.__all__
