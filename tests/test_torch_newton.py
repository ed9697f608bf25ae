"""PyTorch port, Newton (eager and compiled) against the JAX package in
float64.

``_iterate_at_quadrature`` agrees to 1e-13 on a scalar and a vector basis.
Then the cases of the JAX package's ``tests/test_newton.py``, each through
``solve_newton`` and/or ``compiled_newton`` of both packages: nonlinear
Poisson (Jacobi and ``"auto"``), the linear problem in one step, seeded
Dirichlet data in 2D and 3D, per-solve arguments (a backward-Euler step),
the strain-stiffening vector case (eager with its stiffening argument,
compiled, and compiled with the rigid-body-mode ``"auto"``), and the
two-fracture network at h=0.25 (the JAX test's residual and
``bench.dfn_residual``). Held: Newton iteration counts and ``converged``
equal, residual norms within 1e-10 of the initial norm (the scale of the
stopping test ``tol * max(1, res0)``), solutions within 1e-10 relative.
BiCGStab's inner counts are not held: they amplify roundoff (ROADMAP.md,
queue C). The compiled solve returns ``(int, 0-dim tensor, 0-dim bool
tensor)``.
"""

import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_network
from pytorch_fem_solver_tpu_torch import bench, config

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

PI = math.pi
F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]


def _m(b):
    return torch if isinstance(b.v, torch.Tensor) else jnp


def _dot(b, ug):
    return (b.v_grad * ug).sum(-1)[..., None]


def _rhs_2d(p, m):
    x, y = p[..., 0:1], p[..., 1:2]
    u = m.sin(PI * x) * m.sin(PI * y)
    ux = PI * m.cos(PI * x) * m.sin(PI * y)
    uy = PI * m.sin(PI * x) * m.cos(PI * y)
    return -(2 * u * (ux**2 + uy**2) + (1 + u**2) * (-2 * PI**2 * u))


def poisson_residual(b, u, ug):
    return (1.0 + u**2) * _dot(b, ug) - _rhs_2d(b.integration_points, _m(b)) * b.v


def linear_residual(b, u, ug):
    return _dot(b, ug) - b.v


def seeded_residual(axis):
    def residual(b, u, ug):
        f = -2.0 * (1.0 + b.integration_points[..., axis:axis + 1])
        return (1 + u**2) * _dot(b, ug) - f * b.v

    return residual


def network_residual(b, u, ug):
    return (1 + u**2) * _dot(b, ug) - b.v


DT = 1e-3


def heat_residual(b, u, ug, uh_prev):
    return (u - uh_prev) / DT * b.v + (1 + u**2) * _dot(b, ug)


def jax_stiffening(b, u, ug, stiffening=1.0):
    """The residual of the JAX package's ``tests/test_newton.py``."""
    mu_u = 1.0 + stiffening * (u**2).sum(-1, keepdims=True)
    eps_u = 0.5 * (ug + jnp.swapaxes(ug, -1, -2))
    eps_v = 0.5 * (b.v_grad + jnp.swapaxes(b.v_grad, -1, -2))
    div_u = jnp.trace(ug, axis1=-2, axis2=-1)
    div_v = jnp.trace(b.v_grad, axis1=-2, axis2=-1)
    f = jnp.einsum("c,...lc->...l", jnp.asarray([0.0, -1.0]), b.v)[..., None]
    return (2 * mu_u * jnp.einsum("...ocd,...lcd->...lo", eps_u, eps_v)
            + 1.5 * (div_u[..., None, :] * div_v[..., :, None]) - f)


def port_stiffening(b, u, ug, stiffening=1.0):
    """``bench.stiffening_residual`` with the JAX test's stiffening factor
    s: μ(u) = 1 + s |u|^2 is μ of the scaled iterate sqrt(s) u."""
    return bench.stiffening_residual(b, u * math.sqrt(stiffening), ug)


def _rel(ours, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(ours.numpy() - ref).max() / max(np.abs(ref).max(), 1e-300))


def _seed(V, axis):
    coords = np.asarray(V._coords4global_dofs)
    exact = 1.0 + coords[:, axis:axis + 1]
    boundary = np.asarray(V._nodes4boundary_dofs).reshape(-1) != 0
    return np.where(boundary[:, None], exact, 0.0)


@functools.cache
def _tri(max_area, order_q, vector=False):
    cls_j, cls_p = (fem.VectorBasis, pt.VectorBasis) if vector else (fem.Basis, pt.Basis)
    return (
        cls_j(fem.MeshTri(fem.unit_square(max_area=max_area)), fem.ElementTri(1, order_q)),
        cls_p(pt.MeshTri(pt.unit_square(max_area=max_area), device="cpu"), pt.ElementTri(1, order_q)),
    )


def _tet(n):
    return (
        fem.Basis(fem.MeshTet(fem.unit_cube(n)), fem.ElementTet(1, 3)),
        pt.Basis(pt.MeshTet(pt.unit_cube(n), device="cpu"), pt.ElementTet(1, 3)),
    )


def _network():
    return (
        fem.FractureNetworkBasis(jax_network([F1, F2], h=0.25), fem.ElementTri(1, 3)),
        pt.FractureNetworkBasis(pt.build_fracture_network([F1, F2], h=0.25, device="cpu"),
                                pt.ElementTri(1, 3)),
    )


def check_eager(jV, pV, jres, pres, *args, seed=None, **kw):
    """``solve_newton`` of both packages: counts, ``converged``, norms and
    the solution; returns the port's info."""
    js = None if seed is None else jnp.asarray(seed)
    ps = None if seed is None else torch.from_numpy(seed)
    u_ref, info_ref = jV.solve_newton(jres, *args, solution=js, return_info=True, **kw)
    u, info = pV.solve_newton(pres, *args, solution=ps, return_info=True, **kw)
    assert info["iterations"] == info_ref["iterations"]
    assert info["converged"] is info_ref["converged"] is True
    ref_norms = np.asarray(info_ref["residual_norms"])
    assert len(info["residual_norms"]) == len(ref_norms)
    scale = max(1.0, ref_norms[0])
    assert np.abs(np.asarray(info["residual_norms"]) - ref_norms).max() <= 1e-10 * scale
    assert _rel(u, u_ref) <= 1e-10
    return info


def check_compiled(jV, pV, jres, pres, *args, seed=None, **kw):
    """``compiled_newton`` of both packages; returns the port's result."""
    u_ref, (k_ref, res_ref, conv_ref) = jV.compiled_newton(jres, **kw)(
        None if seed is None else jnp.asarray(seed), *[jnp.asarray(a) for a in args]
    )
    u, (k, res, conv) = pV.compiled_newton(pres, **kw)(
        None if seed is None else torch.from_numpy(seed), *[torch.from_numpy(np.array(a)) for a in args]
    )
    assert isinstance(k, int) and k == int(k_ref)
    assert isinstance(res, torch.Tensor) and res.dim() == 0
    assert isinstance(conv, torch.Tensor) and conv.dtype == torch.bool and conv.dim() == 0
    assert bool(conv) is bool(conv_ref) is True
    assert abs(float(res) - float(res_ref)) <= 1e-10
    assert _rel(u, u_ref) <= 1e-10
    return u, k


def test_iterate_at_quadrature_matches_jax():
    rng = np.random.default_rng(1)
    for vector in (False, True):
        jV, pV = _tri(0.5**5, 3, vector)
        cells = rng.standard_normal(tuple(pV._global_dofs4elements.shape))
        (uh_ref, ug_ref), (uh, ug) = (jV._iterate_at_quadrature(jnp.asarray(cells)),
                                      pV._iterate_at_quadrature(torch.from_numpy(cells)))
        nc = pV.n_components if vector else None
        assert uh.shape == uh_ref.shape and ug.shape == ug_ref.shape
        assert uh.shape[-2:] == ((1, nc) if vector else (1, 1))
        assert _rel(uh, uh_ref) <= 1e-13 and _rel(ug, ug_ref) <= 1e-13


def test_nonlinear_poisson():
    jV, pV = _tri(0.5**5, 3)
    info = check_eager(jV, pV, poisson_residual, poisson_residual, tol=1e-12)
    assert info["iterations"] >= 3
    for precondition in ("jacobi", "auto"):
        check_compiled(jV, pV, poisson_residual, poisson_residual, tol=1e-12, solve_tol=1e-10,
                       precondition=precondition)
    with pytest.raises(ValueError, match="unknown precondition"):
        pV.compiled_newton(poisson_residual, precondition="ilu")


@pytest.mark.parametrize("precision", ["highest", None])
def test_compiled_matmul_precision(precision):
    """``matmul_precision`` "highest" and None keep full precision: the
    solve is bitwise the default one; an unknown name raises before any
    table is built."""
    _, pV = _tri(0.5**5, 3)
    kw = dict(tol=1e-12, solve_tol=1e-10, precondition="auto")
    u_ref, (k_ref, res_ref, conv_ref) = pV.compiled_newton(poisson_residual, **kw)()
    u, (k, res, conv) = pV.compiled_newton(poisson_residual, matmul_precision=precision, **kw)()
    assert k == k_ref and bool(conv) and bool(conv_ref)
    assert torch.equal(u, u_ref) and torch.equal(res, res_ref)
    fresh = pt.Basis(pV.mesh, pt.ElementTri(1, 3))
    built = set(vars(fresh))
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        fresh.compiled_newton(poisson_residual, matmul_precision="fastest", **kw)
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        pt.ops.compiled_newton_solver(fresh, poisson_residual, matmul_precision="fastest")
    assert set(vars(fresh)) == built  # no structure was built


def test_linear_problem_in_one_step():
    jV, pV = _tri(0.5**5, 3)
    info = check_eager(jV, pV, linear_residual, linear_residual, tol=1e-10)
    assert info["iterations"] == 1


@pytest.mark.parametrize("dim", [2, 3])
def test_seeded_dirichlet(dim):
    if dim == 2:
        (jV, pV), axis, tol = _tri(0.5**5, 3), 0, 1e-12
    else:
        (jV, pV), axis, tol = _tet(3), 2, 1e-11
    res = seeded_residual(axis)
    seed = _seed(pV, axis)
    check_eager(jV, pV, res, res, seed=seed, tol=tol)
    u, _ = check_compiled(jV, pV, res, res, seed=seed, tol=tol)
    coords = pV._coords4global_dofs.numpy()
    np.testing.assert_allclose(u.numpy(), 1.0 + coords[:, axis:axis + 1], atol=1e-7)


def test_per_solve_arguments():
    jV, pV = _tri(0.5**5, 3)
    coords = pV._coords4global_dofs.numpy()
    u0 = (np.sin(PI * coords[:, 0]) * np.sin(PI * coords[:, 1])).reshape(-1, 1)
    uh0 = np.asarray(jV.interpolate(jV, jnp.asarray(u0))[0])
    check_compiled(jV, pV, heat_residual, heat_residual, uh0, seed=u0, tol=1e-11)


@pytest.mark.parametrize("stiffening", [0.0, 1.0])
def test_vector_stiffening_eager(stiffening):
    jV, pV = _tri(0.5**5, 3, vector=True)
    info = check_eager(jV, pV, jax_stiffening, lambda b, u, ug, s: port_stiffening(b, u, ug, s),
                       stiffening, tol=1e-11 if stiffening == 0.0 else 1e-12)
    assert info["iterations"] == 1 if stiffening == 0.0 else info["iterations"] <= 5


@pytest.mark.parametrize("precondition", ["jacobi", "auto"])
def test_vector_stiffening_compiled(precondition):
    jV, pV = _tri(0.5**5, 3, vector=True)
    check_compiled(jV, pV, jax_stiffening, bench.stiffening_residual, tol=1e-12,
                   precondition=precondition)
    if precondition == "auto":
        assert len(pV._affine_two_level_structures) == 1  # built once, reused per step


def test_network():
    jV, pV = _network()
    check_eager(jV, pV, network_residual, network_residual, tol=1e-12)
    k0 = bench.K0
    check_compiled(
        jV, pV,
        lambda b, u, ug: (k0 + u**2) * (b.v_grad * ug).sum(-1, keepdims=True) - b.v,
        bench.dfn_residual, tol=1e-10, precondition="auto",
    )


def test_compiled_stall_keeps_the_iterate():
    """A residual whose every trial is NaN: the compiled rule damps 12
    times, keeps the iterate and reports the stall as ``max_newton``
    iterations, not converged, as the JAX package does."""
    def residual(b, u, ug):
        bad = torch.where(u != 0, torch.full_like(u, float("nan")), u) if isinstance(u, torch.Tensor) \
            else jnp.where(u != 0, jnp.nan, u)
        return _dot(b, ug) - b.v + bad

    jV, pV = _tri(0.5**5, 3)
    u_ref, (k_ref, res_ref, conv_ref) = jV.compiled_newton(residual, max_newton=7)()
    u, (k, res, conv) = pV.compiled_newton(residual, max_newton=7)()
    assert k == int(k_ref) == 7 and not bool(conv) and not bool(conv_ref)
    assert float(res) == pytest.approx(float(res_ref), rel=1e-12)
    assert torch.equal(u, torch.zeros_like(u)) and not np.asarray(u_ref).any()
