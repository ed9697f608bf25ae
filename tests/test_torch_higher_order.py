"""PyTorch port, P2 and P3 (``ElementTri(2|3, q)``, ``ElementLine(2|3, q)``
and the P2/P3 DOF maps of ``Basis``, ``FractureNetworkBasis``,
``FractureBasis``, ``InteriorEdgesBasis`` and ``BoundaryEdgesBasis``).

In float64 on the CPU, against the JAX package on the same inputs (a unit
square at n=4, the two-fracture network at h=0.35, a two-fracture
``FracturesTri`` of ``rectangle(4, 2)`` charts): shape values and
gradients at seeded reference points to 1e-14; every DOF table and scatter
index byte-identical; shape tables, weights, local and assembled matrices
to 1e-12; the traces onto the edge bases and ``interpolate`` onto itself
to 1e-12; quadratic and cubic reproduction through ``solve`` and
``solve_iterative``; two-sided trace continuity of the oriented P3 edge
DOFs; trace DOFs single on the network and the batched and flat DFN paths
equal DOF for DOF; ``compiled_solver`` at P3 on ``rectangle(8, 8)`` and at
P2 on the network with the JAX package's PCG iteration counts; P4 raising
and the tetrahedral branches building.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_dfn
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench import dfn_p2_solve, p3_poisson
from pytorch_fem_solver_tpu_torch.bench_vpinn import ANCHORS_2D, FRACTURES_3D

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]
CASES = ("basis", "network", "fracture", "interior", "boundary")
QUAD = {2: 4, 3: 5}  # triangle rules
LINE_Q = 4  # the highest Gauss-Legendre rule of element.quadrature


def _mT(x):
    return x.mT if isinstance(x, torch.Tensor) else jnp.matrix_transpose(x)


def stiffness(b):
    return b.v_grad @ _mT(b.v_grad)


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


@pytest.fixture(scope="module")
def meshes():
    tri = fem.rectangle(4, 2, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    ptri = pt.rectangle(4, 2, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    return {
        "square": (fem.MeshTri(fem.unit_square(n=4)), pt.MeshTri(pt.unit_square(n=4), device="cpu")),
        "network": (jax_dfn([F1, F2], h=0.35), pt.build_fracture_network([F1, F2], h=0.35, device="cpu")),
        "fracture": (
            fem.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D),
            pt.FracturesTri([ptri, ptri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D, device="cpu"),
        ),
    }


def _pair(meshes, case, order):
    """(JAX basis, port basis) of ``case`` at ``order``, built once per
    module (the tests only read them)."""
    cache = meshes.setdefault("bases", {})
    if (case, order) not in cache:
        cache[case, order] = _build_pair(meshes, case, order)
    return cache[case, order]


def _build_pair(meshes, case, order):
    q = QUAD[order]
    if case == "basis":
        jm, pm = meshes["square"]
        return fem.Basis(jm, fem.ElementTri(order, q)), pt.Basis(pm, pt.ElementTri(order, q))
    if case == "network":
        jm, pm = meshes["network"]
        return (fem.FractureNetworkBasis(jm, fem.ElementTri(order, q)),
                pt.FractureNetworkBasis(pm, pt.ElementTri(order, q)))
    if case == "fracture":
        jm, pm = meshes["fracture"]
        return (fem.FractureBasis(jm, fem.ElementTri(order, q)),
                pt.FractureBasis(pm, pt.ElementTri(order, q)))
    jm, pm = meshes["square"]
    jcls, pcls = ((fem.InteriorEdgesBasis, pt.InteriorEdgesBasis) if case == "interior"
                  else (fem.BoundaryEdgesBasis, pt.BoundaryEdgesBasis))
    return jcls(jm, fem.ElementLine(order, LINE_Q)), pcls(pm, pt.ElementLine(order, LINE_Q))


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("q", [1, 3, 5])
def test_element_tri_shape_functions_match_jax(order, q):
    je, pe = fem.ElementTri(order, q), pt.ElementTri(order, q)
    np.testing.assert_array_equal(pe.gaussian_nodes.numpy(), np.asarray(je.gaussian_nodes))
    rng = np.random.default_rng(10 * order + q)
    x = rng.uniform(0, 0.5, size=(4, 6, 2))
    bar = pe.compute_barycentric_coordinates(torch.tensor(x))
    jbar = je.compute_barycentric_coordinates(jnp.asarray(x))
    jac = rng.standard_normal((4, 2, 2)) + 2 * np.eye(2)
    _, inv = pe.compute_det_and_inv_map(torch.tensor(jac))
    _, jinv = je.compute_det_and_inv_map(jnp.asarray(jac))
    v, v_grad = pe.compute_shape_functions(bar, inv)
    jv, jv_grad = je.compute_shape_functions(jbar, jinv)
    n_loc = 6 if order == 2 else 10
    assert v.shape == (4, 6, n_loc, 1) and v_grad.shape == (4, 6, n_loc, 2)
    assert _rel(v.numpy(), jv) <= 1e-14 and _rel(v_grad.numpy(), jv_grad) <= 1e-14
    # partition of unity, gradients summing to zero
    assert np.abs(v.numpy().sum(-2) - 1).max() < 1e-13
    assert np.abs(v_grad.numpy().sum(-2)).max() < 1e-12


@pytest.mark.parametrize("order", [2, 3])
def test_element_line_shape_functions_match_jax(order):
    je, pe = fem.ElementLine(order, 4), pt.ElementLine(order, 4)
    rng = np.random.default_rng(order)
    x = rng.uniform(-1, 1, size=(5, 3, 1))
    bar = pe.compute_barycentric_coordinates(torch.tensor(x))
    for d in (2, 3):
        jac = rng.standard_normal((5, d, 1))
        _, inv = pe.compute_det_and_inv_map(torch.tensor(jac))
        _, jinv = je.compute_det_and_inv_map(jnp.asarray(jac))
        v, v_grad = pe.compute_shape_functions(bar, inv)
        jv, jv_grad = je.compute_shape_functions(jnp.asarray(bar.numpy()), jinv)
        assert v.shape == (5, 3, order + 1, 1)
        assert _rel(v.numpy(), jv) <= 1e-14 and _rel(v_grad.numpy(), jv_grad) <= 1e-14


def test_p4_and_tetrahedra_raise():
    """P4 raises in every element; the tetrahedral branches of the DOF maps,
    which raised until the tets were ported, build the cell's 10 / 20 and
    the face's 6 / 10 local DOFs (held against the JAX package in
    ``test_torch_tet.py`` and ``test_torch_faces.py``)."""
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementTri(4, 5)
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementLine(4, 2)
    with pytest.raises(NotImplementedError, match="Polynomial order"):
        pt.ElementTet(4, 5)
    with pytest.raises(NotImplementedError):  # the JAX package raises too
        fem.Basis(fem.MeshTri(fem.unit_square(n=2)), fem.ElementTri(4, 5))
    mesh = pt.MeshTet(pt.unit_cube(1), device="cpu")
    for order, n_cell, n_face in ((2, 10, 6), (3, 20, 10)):
        dofs = pt.Basis._compute_dofs(None, mesh, pt.ElementTet(order, 4))[1]
        assert tuple(dofs.shape) == (6, n_cell)
        faces = pt.InteriorEdgesBasis._compute_dofs(
            SimpleNamespace(facet_group="boundary_faces"), mesh, pt.ElementTriSurface(order, 4)
        )[1]
        assert tuple(faces.shape) == (12, n_face)


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_dof_tables_byte_identical(meshes, case, order):
    jV, pV = _pair(meshes, case, order)
    assert pV.n_dofs == jV.n_dofs
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours = getattr(pV, name)
        assert ours.dtype == torch.int32, name
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jV, name)), err_msg=name)
    np.testing.assert_array_equal(pV._coords4global_dofs.numpy(), np.asarray(jV._coords4global_dofs))
    np.testing.assert_array_equal(pV._coords4elements.numpy(), np.asarray(jV._coords4elements))
    ours, ref = pV._basis_parameters, jV._basis_parameters
    assert sorted(ours) == sorted(ref)
    for key in ("bilinear_form_shape", "linear_form_shape", "nb_dofs"):
        assert tuple(np.atleast_1d(ours[key])) == tuple(np.atleast_1d(ref[key])), key
    for key in ("bilinear_form_idx", "linear_form_idx"):
        for a, b in zip(ours[key], ref[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_array_equal(ours["inner_dofs"].numpy(), np.asarray(ref["inner_dofs"]))


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("case", CASES)
def test_quadrature_and_local_matrices_match_jax(meshes, case, order):
    jV, pV = _pair(meshes, case, order)
    for name in ("v", "v_grad", "integration_points", "_dx", "_inv_map_jacobian"):
        assert _rel(getattr(pV, name).numpy(), getattr(jV, name)) <= 1e-12, name
    local = pV.integrate_bilinear_form_local(stiffness)
    assert _rel(local.numpy(), jV.integrate_bilinear_form_local(stiffness)) <= 1e-12

    def load(b):
        return (1.0 + b.integration_points[..., 0:1] ** 2) * b.v

    assert _rel(pV.integrate_linear_form_local(load).numpy(),
                jV.integrate_linear_form_local(load)) <= 1e-12
    assert _rel(pV.integrate_linear_form(load).numpy(), jV.integrate_linear_form(load)) <= 1e-12
    if case in ("basis", "network"):
        assert _rel(pV.integrate_bilinear_form(stiffness).numpy(),
                    jV.integrate_bilinear_form(stiffness)) <= 1e-12


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("case", ["basis", "network", "fracture"])
def test_interpolate_onto_self_and_traces_match_jax(meshes, case, order):
    jV, pV = _pair(meshes, case, order)
    q = QUAD[order]
    u = np.random.default_rng(order).standard_normal((pV.n_dofs, 1))
    targets = [(jV, pV)]
    if case == "basis":
        jm, pm = meshes["square"]
        targets += [(fem.InteriorEdgesBasis(jm, fem.ElementLine(1, LINE_Q)),
                     pt.InteriorEdgesBasis(pm, pt.ElementLine(1, LINE_Q))),
                    (fem.BoundaryEdgesBasis(jm, fem.ElementLine(1, LINE_Q)),
                     pt.BoundaryEdgesBasis(pm, pt.ElementLine(1, LINE_Q)))]
    elif case == "network":
        jm, pm = meshes["network"]
        targets.append((fem.InteriorEdgesNetworkBasis(jm, fem.ElementLine(1, LINE_Q)),
                        pt.InteriorEdgesNetworkBasis(pm, pt.ElementLine(1, LINE_Q))))
    else:
        jm, pm = meshes["fracture"]
        targets.append((fem.InteriorEdgesFractureBasis(jm, fem.ElementLine(1, LINE_Q)),
                        pt.InteriorEdgesFractureBasis(pm, pt.ElementLine(1, LINE_Q))))
    for jt, ptgt in targets:
        vals, grads = pV.interpolate(ptgt, torch.tensor(u))
        jvals, jgrads = jV.interpolate(jt, jnp.asarray(u))
        assert _rel(vals.numpy(), jvals) <= 1e-12 and _rel(grads.numpy(), jgrads) <= 1e-12
    # the callable form on a function's samples at the DOF coordinates, onto
    # the last target (the edge basis)
    fn, fn_grad = pV.interpolate(ptgt)
    jfn, jfn_grad = jV.interpolate(jt)
    f = lambda c: c[..., 0:1] ** 2 + c[..., 1:2]  # noqa: E731
    assert _rel(fn(f).numpy(), jfn(f)) <= 1e-12
    assert _rel(fn_grad(f).numpy(), jfn_grad(f)) <= 1e-12


@pytest.mark.parametrize("order", [2, 3])
def test_polynomial_reproduction_both_solvers(meshes, order):
    """P2 reproduces x^2 + x y, P3 x^3 + y^3 (lifted Dirichlet data) to
    machine precision through the dense and the BSR solve, with the JAX
    package's answer and PCG iteration count."""
    jV, pV = _pair(meshes, "basis", order)
    coords = pV._coords4global_dofs.numpy()
    x, y = coords[:, 0], coords[:, 1]
    if order == 2:
        exact = (x**2 + x * y).reshape(-1, 1)

        def rhs(p):
            return -2.0 + 0 * p[..., 0:1]
    else:
        exact = (x**3 + y**3).reshape(-1, 1)

        def rhs(p):
            return -(6 * p[..., 0:1] + 6 * p[..., 1:2])

    A = pV.integrate_bilinear_form(stiffness)
    b = pV.integrate_linear_form(lambda b_: rhs(b_.integration_points) * b_.v)
    u_bc, rhs_l = pV.dirichlet_lift(A, b, torch.tensor(exact))
    u = pV.solve(A, u_bc, rhs_l)
    np.testing.assert_allclose(u.numpy(), exact, atol=1e-12)
    u_it, info = pV.solve_iterative(
        pV.integrate_bilinear_form_local(stiffness), rhs_l, solution=u_bc, tol=1e-13,
        return_info=True,
    )
    np.testing.assert_allclose(u_it.numpy(), u.numpy(), atol=1e-11)
    jA = jV.integrate_bilinear_form(stiffness)
    jb = jV.integrate_linear_form(lambda b_: rhs(b_.integration_points) * b_.v)
    ju_bc, jrhs = jV.dirichlet_lift(jA, jb, jnp.asarray(exact))
    _, jinfo = jV.solve_iterative(
        jV.integrate_bilinear_form_local(stiffness), jrhs, solution=ju_bc, tol=1e-13,
        return_info=True,
    )
    assert info.iterations == int(jinfo.iterations)


def test_p3_network_cubic_exact_across_traces(meshes):
    """u* = y^2 (1 - y) is in the P3 space of the glued network and
    continuous across the trace with zero conormal flux: it reproduces to
    machine precision, so both oriented edge DOFs of every trace edge are
    shared."""
    _, pV = _pair(meshes, "network", 3)
    A = pV.integrate_bilinear_form(stiffness)
    b = pV.integrate_linear_form(lambda b_: -(2 - 6 * b_.integration_points[..., 1:2]) * b_.v)
    y = pV._coords4global_dofs[:, 1:2]
    exact = y**2 * (1 - y)
    u_bc, rhs = pV.dirichlet_lift(A, b, exact)
    u = pV.solve(A, u_bc, rhs)
    np.testing.assert_allclose(u.numpy(), exact.numpy(), atol=1e-12)
    u_it = pV.solve_iterative(pV.integrate_bilinear_form_local(stiffness), rhs, solution=u_bc,
                              tol=1e-13)
    np.testing.assert_allclose(u_it.numpy(), u.numpy(), atol=1e-11)


@pytest.mark.parametrize("order", [2, 3])
def test_two_sided_traces_continuous(meshes, order):
    """A random DOF vector evaluated from both sides of every interior edge
    agrees: adjacent cells share the (oriented) edge DOFs."""
    _, pm = meshes["square"]
    V = pt.Basis(pm, pt.ElementTri(order, 4))
    Ve = pt.InteriorEdgesBasis(pm, pt.ElementLine(1, 4))
    u = torch.tensor(np.random.default_rng(0).standard_normal((V.n_dofs, 1)))
    vals, _ = V.interpolate(Ve, u)  # (Ei, 2, q, 1, 1)
    np.testing.assert_allclose(vals[:, 0].numpy(), vals[:, 1].numpy(), atol=1e-11)
    # a facet basis of the same order reads the same DOFs on its edge
    Vf = pt.InteriorEdgesBasis(pm, pt.ElementLine(order, 4))
    facet_vals = (u[Vf._global_dofs4elements.long()][:, None] * Vf.v).sum(-2)
    np.testing.assert_allclose(facet_vals.numpy(), vals[:, 0, :, 0].numpy(), atol=1e-11)


@pytest.mark.parametrize("order", [2, 3])
def test_network_trace_dofs_single_and_batched_equals_flat(order):
    """Every unique global edge of the network has one set of edge DOFs
    (the trace copies collapsed), and the batched ``FractureBasis`` and the
    flat ``FractureNetworkBasis`` solve the same problem DOF for DOF."""
    tri = pt.rectangle(6, 3, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    batched = pt.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D, device="cpu")
    flat = pt.FractureNetworkMesh([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D,
                                  device="cpu")
    q = QUAD[order]
    Vb, Vf = pt.FractureBasis(batched, pt.ElementTri(order, q)), pt.FractureNetworkBasis(
        flat, pt.ElementTri(order, q))
    assert Vb.n_dofs == Vf.n_dofs
    assert int(Vf._global_dofs4elements.max()) + 1 == Vf.n_dofs

    def solve(V):
        return V.solve(V.integrate_bilinear_form(stiffness), V.solution_tensor(),
                       V.integrate_linear_form(lambda b: (1.0 + b.integration_points[..., 1:2]) * b.v))

    ub, uf = solve(Vb), solve(Vf)
    cb = np.round(Vb._coords4global_dofs.numpy(), 9)
    cf = np.round(Vf._coords4global_dofs.numpy(), 9)
    lookup = {tuple(c): i for i, c in enumerate(cf)}
    perm = np.array([lookup[tuple(c)] for c in cb])
    np.testing.assert_allclose(ub.numpy()[:, 0], uf.numpy()[perm, 0], atol=1e-10)


def test_compiled_solver_p3_and_dfn_p2_match_jax(meshes):
    """``compiled_solver`` at P3 on ``rectangle(8, 8)`` (the sine problem of
    ``bench.p3_poisson``) and at P2 on the network (``bench.dfn_p2_solve``):
    the JAX package's PCG iteration counts and solutions."""
    import math

    ours = p3_poisson(8, tol=1e-10, device="cpu")
    assert ours.basis.n_dofs == 25 * 25 and set(ours.seconds) == {"basis", "tables", "solve"}
    V = fem.Basis(fem.MeshTri(fem.rectangle(8, 8)), fem.ElementTri(3, 5))

    def sine(b):
        x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
        return 2 * math.pi**2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y) * b.v

    u, info = V.compiled_solver(stiffness, sine, tol=1e-10)()
    assert ours.info.iterations == int(info.iterations)
    assert _rel(ours.u.numpy(), u) <= 1e-9
    again, _ = ours.solve()
    assert torch.equal(again, ours.u)

    jm, pm = meshes["network"]
    ours = dfn_p2_solve(pm, tol=1e-10)
    u, info = fem.FractureNetworkBasis(jm, fem.ElementTri(2, 4)).compiled_solver(
        stiffness, lambda b: b.v, tol=1e-10)()
    assert ours.info.iterations == int(info.iterations)
    assert _rel(ours.u.numpy(), u) <= 1e-9
