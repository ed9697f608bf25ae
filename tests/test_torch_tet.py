"""PyTorch port, the tetrahedral tier (``ElementTet`` P1-P3, ``MeshTet``,
the tet generators, the tet DOF maps of ``Basis``, ``bench.tet_poisson``).

In float64 on the CPU, against the JAX package on the same inputs: shape
values and gradients at seeded reference points and the analytic 3x3 map
to 1e-13; ``unit_cube``, a non-uniform ``box``, ``fichera_corner`` and
``refine_uniform_tet`` byte-identical, and every ``MeshTet`` group on
``unit_cube(3)`` and ``fichera_corner(2)``; the P1/P2/P3 DOF tables and
scatter indices byte-identical on ``unit_cube(2)`` and ``unit_cube(3)``;
local stiffness and mass to 1e-12; ``compiled_solver`` (through
``tet_poisson``) on ``unit_cube(6)`` at P1 and ``unit_cube(3)`` at P2 and
``solve_iterative(precondition="two_level")`` with the JAX iteration
counts and solutions to 1e-9; the first two levels of
``examples/example_poisson_3d.py`` (L2 and H1 errors to 1e-10); the P3
cubic exactness of ``tests/test_p3.py``.
"""

import importlib.util
import math
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.element import ElementTet as JElementTet
from pytorch_fem_solver_tpu.mesh import MeshTet as JMeshTet
from pytorch_fem_solver_tpu.mesh import fichera_corner as j_fichera_corner
from pytorch_fem_solver_tpu.mesh.generation import refine_uniform_tet as j_refine_uniform_tet
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench import adaptive_tet, tet_poisson, tet_solve

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
QUAD = {1: 2, 2: 4, 3: 5}  # tetrahedron rules


def _mT(x):
    return x.mT if isinstance(x, torch.Tensor) else jnp.matrix_transpose(x)


def stiffness(b):
    return b.v_grad @ _mT(b.v_grad)


def mass(b):
    return b.v @ _mT(b.v)


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


def _assert_groups_equal(ours, ref, path=()):
    """Every table of a port mesh equal to the JAX mesh's, integer tables
    int32 and float tables float64."""
    if isinstance(ref, dict):
        assert set(ours) == set(ref), path
        for key in ref:
            _assert_groups_equal(ours[key], ref[key], path + (key,))
        return
    assert ours.dtype == (torch.float64 if ours.is_floating_point() else torch.int32), path
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=str(path))


GENERATORS = {
    "unit_cube(3)": (lambda m: m.unit_cube(3)),
    "box(2, 3, 1) non-uniform": (lambda m: m.box(2, 3, 1, -0.5, 2.0, 0.0, 0.3, 1.0, 4.0)),
    "fichera_corner(2)": (lambda m: m.fichera_corner(2)),
}


@pytest.fixture(scope="module")
def meshes():
    """name -> (JAX MeshTet, port MeshTet), built once per module."""
    return {
        "unit_cube(2)": (JMeshTet(fem.mesh.unit_cube(2)), pt.MeshTet(pt.unit_cube(2), device="cpu")),
        "unit_cube(3)": (JMeshTet(fem.mesh.unit_cube(3)), pt.MeshTet(pt.unit_cube(3), device="cpu")),
        "fichera_corner(2)": (JMeshTet(j_fichera_corner(2)),
                              pt.MeshTet(pt.fichera_corner(2), device="cpu")),
    }


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("q", [1, 3, 5])
def test_element_tet_shape_functions_match_jax(order, q):
    je, pe = JElementTet(order, q), pt.ElementTet(order, q)
    np.testing.assert_array_equal(pe.gaussian_nodes.numpy(), np.asarray(je.gaussian_nodes))
    np.testing.assert_array_equal(pe.gaussian_weights.numpy(), np.asarray(je.gaussian_weights))
    rng = np.random.default_rng(10 * order + q)
    x = rng.uniform(0, 0.3, size=(4, 6, 3))
    bar = pe.compute_barycentric_coordinates(torch.tensor(x))
    jbar = je.compute_barycentric_coordinates(jnp.asarray(x))
    assert _rel(bar.numpy(), jbar) <= 1e-15
    jac = rng.standard_normal((4, 3, 3)) + 2 * np.eye(3)
    _, inv = pe.compute_det_and_inv_map(torch.tensor(jac))
    _, jinv = je.compute_det_and_inv_map(jnp.asarray(jac))
    v, v_grad = pe.compute_shape_functions(bar, inv)
    jv, jv_grad = je.compute_shape_functions(jbar, jinv)
    n_loc = {1: 4, 2: 10, 3: 20}[order]
    assert v.shape == (4, 6, n_loc, 1)
    assert v_grad.shape == ((4, 1, 4, 3) if order == 1 else (4, 6, n_loc, 3))
    assert _rel(v.numpy(), jv) <= 1e-13 and _rel(v_grad.numpy(), jv_grad) <= 1e-13
    # partition of unity, gradients summing to zero
    assert np.abs(v.numpy().sum(-2) - 1).max() < 1e-13
    assert np.abs(v_grad.numpy().sum(-2)).max() < 1e-12


def test_element_tet_det_and_inverse_match_jax():
    rng = np.random.default_rng(3)
    jac = rng.standard_normal((7, 3, 3)) + 2 * np.eye(3)
    det, inv = pt.ElementTet(1, 1).compute_det_and_inv_map(torch.tensor(jac))
    jdet, jinv = JElementTet(1, 1).compute_det_and_inv_map(jnp.asarray(jac))
    assert det.shape == (7, 1, 1, 1) and inv.shape == (7, 1, 3, 3)
    assert _rel(det.numpy(), jdet) <= 1e-13 and _rel(inv.numpy(), jinv) <= 1e-13
    np.testing.assert_allclose(det.numpy()[:, 0, 0, 0], np.linalg.det(jac), rtol=1e-13)
    np.testing.assert_allclose(inv.numpy()[:, 0], np.linalg.inv(jac), rtol=1e-12, atol=1e-13)
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementTet(4, 5)


@pytest.mark.parametrize("name", sorted(GENERATORS))
@pytest.mark.parametrize("refine", [0, 1, 2])
def test_generators_byte_identical(name, refine):
    ours, ref = GENERATORS[name](pt), GENERATORS[name](fem.mesh)
    if refine:
        ours, ref = pt.refine_uniform_tet(ours, refine), j_refine_uniform_tet(ref, refine)
    assert set(ours) == set(ref) == {"vertices", "tetrahedra", "vertex_markers"}
    for key in ref:
        assert ours[key].dtype == np.asarray(ref[key]).dtype, key
        np.testing.assert_array_equal(ours[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", ["unit_cube(3)", "fichera_corner(2)"])
def test_mesh_tet_groups_byte_identical(meshes, name):
    jm, pm = meshes[name]
    _assert_groups_equal(pm._t, jm._t)
    assert (pm.n_cells, pm.n_vertices, pm.n_interior_faces, pm.dim) == (
        jm.n_cells, jm.n_vertices, jm.n_interior_faces, 3
    )
    assert pm["cells", "length"].shape == (pm.n_cells, 1, 1, 1)
    with pytest.raises(AttributeError, match="faces"):
        pm.n_interior_edges
    # the tetgen-style keys read the same
    again = pt.MeshTet({"vertices": pt.unit_cube(3)["vertices"],
                        "tets": pt.unit_cube(3)["tetrahedra"]}, device="cpu")
    np.testing.assert_array_equal(again["faces", "vertices"].numpy(),
                                  meshes["unit_cube(3)"][1]["faces", "vertices"].numpy())


def _pair(meshes, name, order):
    cache = meshes.setdefault("bases", {})
    if (name, order) not in cache:
        jm, pm = meshes[name]
        q = QUAD[order]
        cache[name, order] = (fem.Basis(jm, JElementTet(order, q)), pt.Basis(pm, pt.ElementTet(order, q)))
    return cache[name, order]


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("name", ["unit_cube(2)", "unit_cube(3)"])
def test_tet_dof_tables_byte_identical(meshes, name, order):
    jV, pV = _pair(meshes, name, order)
    assert pV.n_dofs == jV.n_dofs
    for attr in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours = getattr(pV, attr)
        assert ours.dtype == torch.int32, attr
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jV, attr)), err_msg=attr)
    np.testing.assert_array_equal(pV._coords4global_dofs.numpy(), np.asarray(jV._coords4global_dofs))
    np.testing.assert_array_equal(pV._coords4elements.numpy(), np.asarray(jV._coords4elements))
    ours, ref = pV._basis_parameters, jV._basis_parameters
    assert sorted(ours) == sorted(ref)
    for key in ("bilinear_form_idx", "linear_form_idx"):
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_array_equal(ours["inner_dofs"].numpy(), np.asarray(ref["inner_dofs"]))
    if order == 3:  # 4 vertices, 2 oriented DOFs per edge, a bubble per face
        jm, _ = meshes[name]
        assert pV.n_dofs == (jm.n_vertices + 2 * jm["edges", "vertices"].shape[0]
                             + jm["faces", "vertices"].shape[0])


@pytest.mark.parametrize("order", [1, 2, 3])
def test_local_stiffness_and_mass_match_jax(meshes, order):
    jV, pV = _pair(meshes, "unit_cube(3)", order)
    for name in ("v", "v_grad", "integration_points", "_dx", "_inv_map_jacobian"):
        assert _rel(getattr(pV, name).numpy(), getattr(jV, name)) <= 1e-12, name
    for form in (stiffness, mass):
        assert _rel(pV.integrate_bilinear_form_local(form).numpy(),
                    jV.integrate_bilinear_form_local(form)) <= 1e-12
    assert _rel(pV.integrate_bilinear_form(stiffness).numpy(),
                jV.integrate_bilinear_form(stiffness)) <= 1e-12

    def load(b):
        return (1.0 + b.integration_points[..., 2:3] ** 2) * b.v

    assert _rel(pV.integrate_linear_form(load).numpy(), jV.integrate_linear_form(load)) <= 1e-12


def _jax_sine(b):
    p = b.integration_points
    return (3 * math.pi**2 * jnp.sin(math.pi * p[..., 0:1]) * jnp.sin(math.pi * p[..., 1:2])
            * jnp.sin(math.pi * p[..., 2:3]) * b.v)


@pytest.mark.parametrize("n, order", [(6, 1), (3, 2)])
def test_tet_poisson_matches_jax_compiled_solver(n, order):
    """``bench.tet_poisson`` (``compiled_solver``, aggregate-block M) with
    the JAX package's iteration count and solution on the same problem."""
    ours = tet_poisson(n, order, tol=1e-10, device="cpu")
    assert set(ours.seconds) == {"mesh", "basis", "tables", "solve"}
    jV = fem.Basis(JMeshTet(fem.mesh.unit_cube(n)), JElementTet(order, 2 * order))
    u, info = jV.compiled_solver(stiffness, _jax_sine, tol=1e-10)()
    assert ours.info.iterations == int(info.iterations)
    assert _rel(ours.u.numpy(), u) <= 1e-9
    again, _ = ours.solve()
    assert torch.equal(again, ours.u)
    other = tet_solve(ours.basis.mesh, order, tol=1e-10)
    assert torch.equal(other.u, ours.u)


def test_solve_iterative_two_level_matches_jax(meshes):
    """``solve_iterative`` on the BSR operator with the aggregate two-level
    M and the canonical-pair assembly, P1 and P2 on ``unit_cube(3)``."""
    for order in (1, 2):
        jV, pV = _pair(meshes, "unit_cube(3)", order)
        kw = dict(tol=1e-10, precondition="two_level", symmetric_form=True, return_info=True)
        u, info = pV.solve_iterative(pV.integrate_bilinear_form_local(stiffness),
                                     pV.integrate_linear_form(_port_sine), **kw)
        ju, jinfo = jV.solve_iterative(jV.integrate_bilinear_form_local(stiffness),
                                       jV.integrate_linear_form(_jax_sine), **kw)
        assert info.iterations == int(jinfo.iterations) > 1
        assert _rel(u.numpy(), ju) <= 1e-9


def _port_sine(b):
    p = b.integration_points
    return (3 * math.pi**2 * torch.sin(math.pi * p[..., 0:1]) * torch.sin(math.pi * p[..., 1:2])
            * torch.sin(math.pi * p[..., 2:3]) * b.v)


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(EXAMPLES))
    return module


def test_example_poisson_3d_first_two_levels():
    """The first two levels of ``examples/example_poisson_3d.py`` (P1, n =
    3 and 6, ``solve_iterative`` to 1e-10): the same iteration counts and
    L2 and H1 errors to 1e-10."""
    ex = _example("example_poisson_3d")
    pi = math.pi

    def exact(p):
        return torch.sin(pi * p[..., 0:1]) * torch.sin(pi * p[..., 1:2]) * torch.sin(pi * p[..., 2:3])

    def grad_exact(p):
        x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        s, c = torch.sin, torch.cos
        return pi * torch.cat([c(pi * x) * s(pi * y) * s(pi * z), s(pi * x) * c(pi * y) * s(pi * z),
                               s(pi * x) * s(pi * y) * c(pi * z)], dim=-1)

    for n in (ex.N0, 2 * ex.N0):
        jV = fem.Basis(JMeshTet(fem.mesh.unit_cube(n)), JElementTet(1, 3))
        ju, jinfo = jV.solve_iterative(jV.integrate_bilinear_form_local(ex.stiffness_form),
                                       jV.integrate_linear_form(ex.load_form), tol=1e-10,
                                       return_info=True)
        juh, jugh = jV.interpolate(jV, ju)
        je2 = (juh - ex.u_exact(jV.integration_points)) ** 2
        jg2 = ((jugh - ex.grad_exact(jV.integration_points)) ** 2).sum(-1, keepdims=True)
        jl2 = float(jnp.sqrt(jnp.sum(jV.integrate_functional(lambda b_: je2))))
        jh1 = float(jnp.sqrt(jnp.sum(jV.integrate_functional(lambda b_: je2 + jg2))))

        V = pt.Basis(pt.MeshTet(pt.unit_cube(n), device="cpu"), pt.ElementTet(1, 3))
        u, info = V.solve_iterative(V.integrate_bilinear_form_local(stiffness),
                                    V.integrate_linear_form(_port_sine), tol=1e-10, return_info=True)
        uh, ugh = V.interpolate(V, u)
        e2 = (uh - exact(V.integration_points)) ** 2
        g2 = ((ugh - grad_exact(V.integration_points)) ** 2).sum(-1, keepdim=True)
        l2 = float(torch.sqrt(V.integrate_functional(lambda b_: e2).sum()))
        h1 = float(torch.sqrt(V.integrate_functional(lambda b_: e2 + g2).sum()))
        assert info.iterations == int(jinfo.iterations)
        assert abs(l2 - jl2) <= 1e-10 * jl2 and abs(h1 - jh1) <= 1e-10 * jh1, (n, l2, jl2, h1, jh1)


def test_p3_tet_layout_and_cubic_exactness():
    """``tests/test_p3.py``'s 3D P3 case through the port: 20 local DOFs,
    u* = x^3 + y^3 + z^3 reproduced through both solve paths."""
    mesh = pt.MeshTet(pt.unit_cube(2), device="cpu")
    V = pt.Basis(mesh, pt.ElementTet(3, 4))
    nv, ne, nf = mesh.n_vertices, mesh["edges", "vertices"].shape[0], mesh["faces", "vertices"].shape[0]
    assert V.n_dofs == nv + 2 * ne + nf
    assert V._global_dofs4elements.shape[-1] == 20
    assert np.abs(V.v.numpy().sum(-2) - 1.0).max() < 1e-13
    coords = V._coords4global_dofs
    A = V.integrate_bilinear_form(stiffness)
    b = V.integrate_linear_form(lambda b_: -6.0 * b_.integration_points.sum(-1, keepdim=True) * b_.v)
    exact = (coords**3).sum(dim=1, keepdim=True)
    u_bc, rhs = V.dirichlet_lift(A, b, exact)
    u = V.solve(A, u_bc, rhs)
    np.testing.assert_allclose(u.numpy(), exact.numpy(), atol=1e-12)
    u_it = V.solve_iterative(V.integrate_bilinear_form_local(stiffness), rhs, solution=u_bc, tol=1e-13)
    np.testing.assert_allclose(u_it.numpy(), u.numpy(), atol=1e-10)


def test_tet_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.MeshTet(pt.unit_cube(1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tet_poisson(1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(adaptive_tet(pt.fichera_corner(1), 1))
