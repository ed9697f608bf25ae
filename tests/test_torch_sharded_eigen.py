"""PyTorch port, ``parallel/sharded_eigen.py:sharded_eigsh_solver`` against
the JAX package in float64.

The port's ranks are gloo processes on the CPU, 2 and 4 of them, spawned
once per module in the background (``torch_dist_worker.start``); each test
reads its own case. The JAX side runs here through ``make_device_mesh(n)``
of the conftest's 8 virtual devices with the same n, while the ranks run
(the ``refs`` fixture). For the LOBPCG cases
of the JAX package's ``tests/test_sharding.py`` (k=4 on P1
``unit_square(max_area=0.5**8)`` with the two-level M and with Jacobi, k=3
on ``unit_cube(5)`` at 2 ranks): every rank's result equal to rank 0's,
the rounds equal to JAX's sharded count (the same seed draws the same start
block), eigenvalues within 1e-10 relative of JAX's (Jacobi's 1e-6, the JAX
test's bound) and the eigenvectors spanning JAX's M-orthonormal space.
"""

import functools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import make_device_mesh, sharded_eigsh_solver
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr as psb
from pytorch_fem_solver_tpu_torch.parallel import sharded_eigsh_solver as port_eigsh

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    pool, futures = worker.start("sharded_eigen", str(tmp_path_factory.mktemp("eigen")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def stiffness(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def mass(b):
    return b.v @ jnp.matrix_transpose(b.v)


@functools.cache
def square():
    return fem.Basis(fem.MeshTri(fem.unit_square(max_area=0.5**8)), fem.ElementTri(1, 3))


@pytest.fixture(scope="module")
def refs(runs):
    """JAX's sharded solves of the rank cases, computed in threads while
    the ranks run, by (case, world): the basis, k and the solve."""

    def solve(V, k, world, **kw):
        return V, k, sharded_eigsh_solver(V, stiffness, mass, k=k, tol=1e-9,
                                          device_mesh=make_device_mesh(world), **kw)()

    V = square()
    return worker.in_threads({
        (f"eigsh_{pc}", world): functools.partial(solve, V, 4, world, precondition=pc)
        for pc in ("two_level", "jacobi") for world in WORLDS})


def check_eigsh(runs, refs, world, name, rtol):
    """The ranks' case against JAX's sharded solve at ``world`` devices:
    both converged, equal rounds, eigenvalues within ``rtol``, and the
    singular values of X_port^T M X_jax all 1 to 1e-8 (the same
    M-orthonormal span, whatever the signs and the rotations inside the
    double eigenvalue)."""
    V, k, (vals, vecs, (r_ref, _, cv_ref)) = refs[name, world]
    res = worker.case(runs, world, name)
    assert res["conv"] is bool(cv_ref) is True
    assert res["it"] == int(r_ref)
    np.testing.assert_allclose(res["vals"], np.asarray(vals), rtol=rtol)
    assert res["u"].shape == vecs.shape == (V.n_dofs, k)
    m = np.asarray(V.integrate_bilinear_form(mass))
    sv = np.linalg.svd(res["u"].T @ m @ np.asarray(vecs), compute_uv=False)
    np.testing.assert_allclose(sv, 1.0, atol=1e-8)
    assert res["type"] == ("int", 0, 0)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eigsh_matches_jax(runs, refs, world):
    check_eigsh(runs, refs, world, "eigsh_two_level", 1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_eigsh_jacobi(runs, refs, world):
    check_eigsh(runs, refs, world, "eigsh_jacobi", 1e-6)



def test_unknown_names_raise_before_any_table():
    V = worker.square(n=4)
    with pytest.raises(ValueError, match="unknown precondition: 'ilu'"):
        port_eigsh(V, worker.stiffness, worker.mass, precondition="ilu")
    with pytest.raises(ValueError, match="unknown matmul_precision: 'bogus'"):
        port_eigsh(V, worker.stiffness, worker.mass, matmul_precision="bogus")
    assert V not in psb._PLANS and not getattr(V, "_bsr_structures", None)
