"""PyTorch port, the sharded Newton, eigen and Stokes solvers on
tetrahedra against the JAX package in float64.

The JAX package's ``tests/test_sharding.py`` holds its sharded solvers on
tet meshes in two tests (the paths never look at the dimension); here the
three cases share one spawn of 2 gloo ranks on the CPU
(``torch_dist_worker.start``) and this process's JAX side on
``make_device_mesh(2)`` of the conftest's 8 virtual devices, computed while
the ranks run (the ``refs`` fixture): Newton (-div((1 + u^2) grad u) = f,
the two-level M) and LOBPCG (k=3) on P1 ``unit_cube(5)``, Stokes (P2 x 3 /
P1 Taylor-Hood, Jacobi) on ``unit_cube(3)``. Held: every rank's result
equal to rank 0's, the Newton steps, LOBPCG rounds and Stokes outer
iterations equal to JAX's sharded counts (the Stokes inner total within 2:
its Jacobi inner solves end at float64's attainable accuracy), the Newton
solution within 1e-10 relative, eigenvalues within 1e-10 relative and the
Stokes fields within the JAX test's 1e-8 x max|u| and 1e-7.
"""

import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import (
    make_device_mesh,
    sharded_eigsh_solver,
    sharded_newton_solver,
    sharded_stokes_solver,
)
from pytorch_fem_solver_tpu_torch import config

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLD = 2


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < WORLD:
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharded_tets", str(tmp_path_factory.mktemp("tets")), (WORLD,))
    yield futures
    pool.shutdown(wait=True)


def residual_3d(b_, u, ug):
    pi = math.pi
    p = b_.integration_points
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    us = jnp.sin(pi * x) * jnp.sin(pi * y) * jnp.sin(pi * z)
    ux = pi * jnp.cos(pi * x) * jnp.sin(pi * y) * jnp.sin(pi * z)
    uy = pi * jnp.sin(pi * x) * jnp.cos(pi * y) * jnp.sin(pi * z)
    uz = pi * jnp.sin(pi * x) * jnp.sin(pi * y) * jnp.cos(pi * z)
    f = -(2 * us * (ux**2 + uy**2 + uz**2) + (1 + us**2) * (-3 * pi**2 * us))
    return (1 + u**2) * (b_.v_grad * ug).sum(-1, keepdims=True) - f * b_.v


def stiffness(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def mass(b):
    return b.v @ jnp.matrix_transpose(b.v)


def a_form(b):
    g = b.v_grad
    return jnp.einsum("...icd,...jcd->...ij", g, g)


def div_form(test_p, trial_u):
    div = jnp.trace(trial_u.v_grad, axis1=-2, axis2=-1)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def load_3d(b):
    f = jnp.asarray([1.0, 0.0, -0.5])
    return (f * b.v).sum(-1, keepdims=True)


@pytest.fixture(scope="module")
def refs(runs):
    """JAX's sharded solves of the three cases at 2 devices, the bases and
    then the solves in threads while the ranks run."""
    mesh = make_device_mesh(WORLD)

    def scalar():
        return fem.Basis(fem.MeshTet(fem.unit_cube(5)), fem.ElementTet(1, 2))

    def taylor_hood():
        cube = fem.MeshTet(fem.unit_cube(3))
        Vu = fem.VectorBasis(cube, fem.ElementTet(2, 3))
        return Vu, fem.Basis(cube, fem.ElementTet(1, 3)), Vu.integrate_linear_form(load_3d)

    bases = worker.in_threads({"scalar": scalar, "taylor_hood": taylor_hood})
    V = bases["scalar"]
    Vu, Vp, f = bases["taylor_hood"]
    return worker.in_threads({
        "newton": lambda: sharded_newton_solver(V, residual_3d, device_mesh=mesh, tol=1e-12,
                                                solve_tol=1e-10, precondition="two_level")(),
        "eigsh": lambda: sharded_eigsh_solver(V, stiffness, mass, k=3, tol=1e-9,
                                              device_mesh=mesh)(),
        "stokes": lambda: sharded_stokes_solver(Vu, Vp, a_form, div_form, device_mesh=mesh,
                                                tol=1e-9, inner_tol=1e-11,
                                                precondition="jacobi")(f),
    })


def test_sharded_newton_on_tet_mesh(runs, refs):
    u_ref, (k_ref, _, conv_ref) = refs["newton"]
    res = worker.case(runs, WORLD, "newton_tet")
    assert res["conv"] is bool(conv_ref) is True
    assert res["it"] == int(k_ref)
    assert worker.rel(res["u"], u_ref) <= 1e-10


def test_sharded_eigsh_on_tet_mesh(runs, refs):
    vals, vecs, (r_ref, _, cv_ref) = refs["eigsh"]
    res = worker.case(runs, WORLD, "eigsh_tet")
    assert res["conv"] is bool(cv_ref) is True
    assert res["it"] == int(r_ref)
    np.testing.assert_allclose(res["vals"], np.asarray(vals), rtol=1e-10)
    assert res["u"].shape == vecs.shape


def test_sharded_stokes_on_tet_mesh(runs, refs):
    u_ref, p_ref, info_ref = refs["stokes"]
    res = worker.case(runs, WORLD, "stokes_tet")
    assert res["conv"] is bool(info_ref.converged) is True
    assert res["it"] == int(info_ref.outer_iterations)
    # Jacobi's inner solves end at float64's attainable accuracy, where the
    # two packages' last iterations differ by roundoff
    assert abs(res["inner_total"] - int(info_ref.inner_total)) <= 2
    scale = float(np.abs(np.asarray(u_ref)).max())
    np.testing.assert_allclose(res["u"], np.asarray(u_ref), atol=1e-8 * max(scale, 1.0))
    np.testing.assert_allclose(res["p"], np.asarray(p_ref), atol=1e-7)
