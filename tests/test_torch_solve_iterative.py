"""PyTorch port, the solve surface of ``AbstractBasis`` and
``Basis.interpolate``.

In float64 on the CPU, on the h=0.25 seven-fracture DFN (1,587 DOFs) and a
unit square, against the JAX package:

* ``solve_iterative`` over method (``bsr``, ``ell``, ``segment``) x
  precondition (``jacobi``, ``agg_block``, ``two_level``) x solver (``cg``,
  ``bicgstab``), plus the canonical-pair assembly ``symmetric_form=True``:
  equal iteration counts, solutions within 1e-9 relative;
* ``solve`` and ``dirichlet_lift`` (dense LU, a non-homogeneous boundary
  lifted), 1e-12;
* ``Basis.interpolate`` of a DOF vector and of a function's nodal samples,
  values and gradients, 1e-13;
* ``precondition="mult_two_level"`` in the JAX iteration count; the
  raises: names the JAX package refuses, ``rbm`` on a scalar basis,
  interpolation onto a cell basis of another mesh (refused by both
  packages).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

TOL = 1e-10


def _stiffness(b):
    if isinstance(b.v_grad, torch.Tensor):
        return b.v_grad @ b.v_grad.mT
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def _load(b):
    x = b.integration_points[..., 0:1]
    sin = torch.sin if isinstance(x, torch.Tensor) else jnp.sin
    return (1.0 + sin(3.0 * x)) * b.v


@pytest.fixture(scope="module")
def dfn():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jm._t), device="cpu")
    jV = fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2))
    pV = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    return (
        jV, pV,
        jV.integrate_bilinear_form_local(_stiffness), pV.integrate_bilinear_form_local(_stiffness),
        jV.integrate_linear_form(_load), pV.integrate_linear_form(_load),
    )


@pytest.fixture(scope="module")
def square():
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(n=8)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.unit_square(n=8), device="cpu"), pt.ElementTri(1, 2)),
    )


def _rel(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


CASES = [
    ("bsr", "jacobi", "cg"),
    ("bsr", "agg_block", "cg"),
    ("bsr", "two_level", "cg"),
    ("bsr", "two_level", "bicgstab"),
    ("ell", "jacobi", "cg"),
    ("ell", "two_level", "cg"),
    ("ell", "two_level", "bicgstab"),
    ("segment", "jacobi", "cg"),
]


@pytest.mark.parametrize("method,precondition,solver", CASES, ids=["-".join(c) for c in CASES])
def test_solve_iterative_matches_jax(dfn, method, precondition, solver):
    jV, pV, jl, pl, jb, pb = dfn
    kw = dict(tol=TOL, method=method, precondition=precondition, solver=solver, return_info=True)
    u, info = pV.solve_iterative(pl, pb, **kw)
    u_ref, info_ref = jV.solve_iterative(jl, jb, **kw)
    assert info.iterations == int(info_ref.iterations) > 0
    assert bool(info.converged) and bool(info_ref.converged)
    assert _rel(u, u_ref) <= 1e-9
    assert isinstance(info.iterations, int)


def test_symmetric_form_and_a_given_solution_match_jax(dfn):
    jV, pV, jl, pl, jb, pb = dfn
    offset = np.random.default_rng(0).standard_normal((pV.n_dofs, 1))
    kw = dict(tol=TOL, precondition="two_level", symmetric_form=True)
    u = pV.solve_iterative(pl, pb, solution=torch.from_numpy(offset), **kw)
    u_ref = jV.solve_iterative(jl, jb, solution=jnp.asarray(offset), **kw)
    assert _rel(u, u_ref) <= 1e-9
    plain = pV.solve_iterative(pl, pb, tol=TOL, precondition="two_level")
    assert _rel(u - torch.from_numpy(offset), plain) <= 1e-9


def test_ell_two_level_tables_are_cached_on_the_basis(dfn):
    _, pV, _, pl, _, pb = dfn
    pV.solve_iterative(pl, pb, tol=1e-6, method="ell", precondition="two_level")
    tl = pV._two_level_structure
    pV.solve_iterative(pl, pb, tol=1e-6, method="ell", precondition="two_level")
    assert pV._two_level_structure is tl
    # the Gram solver's two-level M (same ELL layout, leaf 32, kp 4) reuses them
    gram = pV.gram_solver(_stiffness, method="pcg")
    assert pV._two_level_structure is tl
    assert torch.equal(gram.precond.p_cols, tl.p_cols.long())


def _lifted_problem(pkg, V):
    """-Δu = 1 with u = x + 2 y on the boundary, lifted to the rhs."""
    is_port = pkg is pt
    A = V.integrate_bilinear_form(_stiffness)
    b = V.integrate_linear_form(lambda v: v.v)
    nodes = V._coords4global_dofs
    g = (nodes[:, 0:1] + 2.0 * nodes[:, 1:2])
    if is_port:
        g = g.to(A.dtype)
    u_bc, rhs = V.dirichlet_lift(A, b, g)
    return u_bc, rhs, V.solve(A, u_bc, rhs), g


def test_solve_and_dirichlet_lift_match_jax(square):
    jV, pV = square
    ours = _lifted_problem(pt, pV)
    ref = _lifted_problem(fem, jV)
    for o, r in zip(ours[:3], ref[:3]):
        assert _rel(o, r) <= 1e-12
    # the boundary values are exact in the solution, the interior ones zero
    # in the lift
    u, g = ours[2], ours[3]
    inner = pV._basis_parameters["inner_dofs"].long()
    boundary = torch.ones(pV.n_dofs, dtype=torch.bool)
    boundary[inner] = False
    assert torch.equal(u[boundary], g[boundary])
    assert not ours[0][inner].any()


@pytest.mark.parametrize("mesh", ["dfn", "square"])
def test_interpolate_matches_jax(mesh, dfn, square):
    jV, pV = (dfn[0], dfn[1]) if mesh == "dfn" else square
    u = np.random.default_rng(1).standard_normal((pV.n_dofs, 1))
    values, grads = pV.interpolate(pV, torch.from_numpy(u))
    ref_values, ref_grads = jV.interpolate(jV, jnp.asarray(u))
    assert _rel(values, ref_values) <= 1e-13 and _rel(grads, ref_grads) <= 1e-13
    assert values.shape[-2:] == (1, 1)

    def f(pkg):
        sin = torch.sin if pkg is pt else jnp.sin
        return lambda c: sin(math.pi * c[..., 0:1]) * (1.0 + c[..., 1:2])

    interp, interp_grad = pV.interpolate(pV)
    ref, ref_grad = jV.interpolate(jV)
    assert _rel(interp(f(pt)), ref(f(fem))) <= 1e-13
    assert _rel(interp_grad(f(pt)), ref_grad(f(fem))) <= 1e-13


def test_named_raises(dfn, square):
    jV, pV, jl, pl, jb, pb = dfn
    # the multiplicative cycle runs as the JAX package's does
    u_ref, info_ref = jV.solve_iterative(jl, jb, precondition="mult_two_level", return_info=True)
    u, info = pV.solve_iterative(pl, pb, precondition="mult_two_level", return_info=True)
    assert info.iterations == int(info_ref.iterations) and bool(info.converged)
    assert _rel(u, u_ref) <= 1e-10
    # the rigid-body-mode space needs a vector basis: the JAX package's text
    with pytest.raises(ValueError) as ref:
        jV.solve_iterative(jl, jb, precondition="rbm")
    with pytest.raises(ValueError, match="requires a vector basis") as ours:
        pV.solve_iterative(pl, pb, precondition="rbm")
    assert str(ours.value) == str(ref.value)
    with pytest.raises(ValueError, match="unknown precondition"):
        pV.solve_iterative(pl, pb, precondition="ilu")
    with pytest.raises(ValueError, match="unknown solver"):
        pV.solve_iterative(pl, pb, solver="gmres")
    with pytest.raises(ValueError, match="symmetric_form"):
        pV.solve_iterative(pl, pb, method="ell", symmetric_form=True)
    with pytest.raises(NotImplementedError, match="requires method='ell'"):
        pV.solve_iterative(pl, pb, method="segment", precondition="two_level")
    with pytest.raises(NotImplementedError, match="reduced"):
        pV.solve_iterative(pl, pb, only_inner_dofs=False)
    with pytest.raises(ValueError, match="unknown gram_solver method"):
        pV.gram_solver(_stiffness, method="lu")
    # the JAX package refuses the same names the same way
    with pytest.raises(ValueError, match="unknown precondition"):
        jV.solve_iterative(jl, jb, precondition="ilu")
    # interpolation onto a cell basis of another mesh is refused by both
    # packages with the same text (the edge bases are ported)
    jsq, sq = square
    for basis, other in ((pV, sq), (jV, jsq)):
        with pytest.raises(NotImplementedError, match="Interpolation for this basis not implemented"):
            basis.interpolate(other)
