"""PyTorch port, ``parallel/sharded_newton.py:sharded_newton_solver``
against the JAX package in float64.

The port's ranks are gloo processes on the CPU, 2 and 4 of them, spawned
once per module in the background (``torch_dist_worker.start``); each test
reads its own case. The JAX side runs here through ``make_device_mesh(n)``
of the conftest's 8 virtual devices with the same n, while the ranks run
(the ``refs`` fixture). For the Newton cases
of the JAX package's ``tests/test_sharding.py`` (-div((1 + u^2) grad u) = f
on a P1 ``rectangle(40, 40)`` with Jacobi and the two-level M; the tet case
is in ``test_torch_sharded_tets.py``): every rank's result equal to rank 0's, the
Newton steps equal to JAX's sharded count, solutions within 1e-10 relative
of JAX's. The 50k-DOF case runs with ``FEM_TEST_SCALE=1``, as in the JAX
package. The unknown-name errors are raised before any table is built.
"""

import functools
import math
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import make_device_mesh, sharded_newton_solver
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr as psb
from pytorch_fem_solver_tpu_torch.parallel import sharded_newton_solver as port_newton

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)
KW = {"tol": 1e-12, "solve_tol": 1e-10}


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharded_newton", str(tmp_path_factory.mktemp("newton")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def residual(b_, u, ug):
    pi = math.pi
    x, y = b_.integration_points[..., 0:1], b_.integration_points[..., 1:2]
    us = jnp.sin(pi * x) * jnp.sin(pi * y)
    ux = pi * jnp.cos(pi * x) * jnp.sin(pi * y)
    uy = pi * jnp.sin(pi * x) * jnp.cos(pi * y)
    f = -(2 * us * (ux**2 + uy**2) + (1 + us**2) * (-2 * pi**2 * us))
    return (1 + u**2) * (b_.v_grad * ug).sum(-1, keepdims=True) - f * b_.v


def rectangle(n):
    return fem.Basis(fem.MeshTri(fem.rectangle(n, n)), fem.ElementTri(1, 3))


def jax_newton(V, form, world, **kw):
    return sharded_newton_solver(V, form, device_mesh=make_device_mesh(world), **kw)()


@pytest.fixture(scope="module")
def refs(runs):
    """JAX's sharded solves of the rank cases, computed in threads while
    the ranks run, by (case, world)."""
    V = rectangle(40)
    return worker.in_threads({
        (f"newton_{pc}", world): functools.partial(jax_newton, V, residual, world,
                                                   precondition=pc, **KW)
        for pc in ("jacobi", "two_level") for world in WORLDS})


def check_newton(runs, world, name, ref):
    """The ranks' case against JAX's sharded solve at ``world`` devices:
    both converged, equal Newton steps, solutions within 1e-10 relative,
    a Python int count and 0-dim tensors."""
    u_ref, (k_ref, _, conv_ref) = ref
    res = worker.case(runs, world, name)
    assert res["conv"] is bool(conv_ref) is True
    assert res["it"] == int(k_ref)
    assert res["u"].shape == u_ref.shape
    assert worker.rel(res["u"], u_ref) <= 1e-10
    assert res["type"] == ("int", 0, 0)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("precondition", ["jacobi", "two_level"])
def test_sharded_newton_matches_jax(runs, refs, world, precondition):
    name = f"newton_{precondition}"
    check_newton(runs, world, name, refs[name, world])


@pytest.mark.skipif(not os.environ.get("FEM_TEST_SCALE"),
                    reason="heavy CPU Newton at 50k DOFs; set FEM_TEST_SCALE=1")
@pytest.mark.parametrize("world", WORLDS)
def test_sharded_newton_stress_50k(runs, world):
    V = rectangle(224)
    assert V.n_dofs >= 50_000
    check_newton(runs, world, "newton_50k", jax_newton(V, residual, world, tol=1e-10,
                                                       solve_tol=1e-9, precondition="two_level"))


def test_unknown_names_raise_before_any_table():
    """``precondition="ilu"`` raises the reference's text and an unknown
    ``matmul_precision`` raises, both before a plan or a structure is
    built (no process group is needed to reach them)."""
    V = worker.square(n=4)
    with pytest.raises(ValueError, match="unknown precondition: 'ilu'"):
        port_newton(V, worker.nonlinear_residual, precondition="ilu")
    with pytest.raises(ValueError, match="unknown matmul_precision: 'bogus'"):
        port_newton(V, worker.nonlinear_residual, matmul_precision="bogus")
    assert V not in psb._PLANS and not getattr(V, "_bsr_structures", None)
