"""PyTorch port, ``parallel/sharded_bsr.py:solve_pcg_sharded_bsr`` against
the JAX package in float64.

The port's ranks are gloo processes on the CPU, 2 and 4 of them, spawned
once per module in the background (``torch_dist_worker.start``); each test
reads its own case. The JAX side runs here through ``make_device_mesh(n)``
of the conftest's 8 virtual devices with the same n. For the BSR cases of
the JAX package's ``tests/test_sharding.py`` and
``tests/test_sharded_bsr.py`` (two-level and Jacobi on the square, the
two-fracture network at h=0.2, a tet mesh, the legacy entry point with a
generic load): every rank's result equal to rank 0's, iteration counts
equal to JAX's sharded counts, solutions within 1e-10 relative of JAX's,
and two-level faster than Jacobi. The seven-fracture network's case is in
``test_torch_sharded_bsr.py``, which builds that mesh anyway.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_network
from pytorch_fem_solver_tpu.parallel import make_device_mesh, solve_pcg_sharded_bsr
from pytorch_fem_solver_tpu_torch import config

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharded_bsr_pcg", str(tmp_path_factory.mktemp("pcg")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def stiffness(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (1.0 + x + y) * b.v


def generic_load(b):
    """Not the sine load: on the structured square that rhs is a discrete
    eigenvector and Jacobi-CG converges in 2 iterations."""
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (x * x + jnp.exp(y)) * b.v


def cube_load(b):
    p = b.integration_points
    return (1.0 + p[..., 0:1] + p[..., 1:2] + p[..., 2:3]) * b.v


def unit_load(b):
    return b.v


@functools.cache
def square():
    return fem.Basis(fem.MeshTri(fem.unit_square(max_area=0.5**9)), fem.ElementTri(1, 2))


def check_solve(runs, world, name, V, form, **kw):
    local = V.integrate_bilinear_form_local(stiffness)
    b = V.integrate_linear_form(form)
    u_ref, info_ref = solve_pcg_sharded_bsr(V, local, b, make_device_mesh(world),
                                            return_info=True, **kw)
    res = worker.case(runs, world, name)
    assert res["it"] == int(info_ref.iterations)
    assert res["conv"] is bool(info_ref.converged) is True
    assert worker.rel(res["u"], u_ref) <= 1e-10
    return res


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("precondition", ["two_level", "jacobi"])
def test_sharded_bsr_pcg_matches_jax(runs, world, precondition):
    V = square()
    name = "bsr_square" if precondition == "two_level" else "bsr_square_jacobi"
    check_solve(runs, world, name, V, load, tol=1e-13, precondition=precondition)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bsr_pcg_on_fracture_network(runs, world):
    V = fem.FractureNetworkBasis(jax_network([worker.F1, worker.F2], h=0.2), fem.ElementTri(1, 2))
    check_solve(runs, world, "bsr_network", V, unit_load, tol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_bsr_on_tet_mesh(runs, world):
    """``solve_pcg_sharded_bsr`` on tets (tier-1 cap 24): the sharded
    paths never look at the dimension."""
    V = fem.Basis(fem.MeshTet(fem.unit_cube(4)), fem.ElementTet(1, 2))
    check_solve(runs, world, "tet_bsr", V, cube_load, tol=1e-13)


@pytest.mark.parametrize("world", WORLDS)
def test_legacy_entrypoint_on_new_core(runs, world):
    """``solve_pcg_sharded_bsr`` two-level and Jacobi at JAX's counts; the
    two-level preconditioner takes fewer iterations than Jacobi."""
    V = square()
    local = V.integrate_bilinear_form_local(stiffness)
    b = V.integrate_linear_form(generic_load)
    res = worker.case(runs, world, "legacy")
    mesh = make_device_mesh(world)
    for key, tol, pc in (("two_level", 1e-12, "two_level"), ("jacobi", 1e-10, "jacobi")):
        u_ref, info_ref = solve_pcg_sharded_bsr(V, local, b, mesh, tol=tol, precondition=pc,
                                                return_info=True)
        assert res[key]["it"] == int(info_ref.iterations) and res[key]["conv"]
        assert worker.rel(res[key]["u"], u_ref) <= 1e-10
    assert res["two_level"]["it"] < res["jacobi"]["it"]


