"""PyTorch port, ``parallel/sharded_stokes.py:sharded_stokes_solver``
against the JAX package in float64.

Host side, in this process: the shard plan of the Taylor-Hood velocity
basis (a P2 ``VectorBasis`` on ``rectangle(9, 7)``) byte-identical to
JAX's at 1, 2 and 4 shards. Ranks: gloo processes on the CPU, 2 and 4 of
them, spawned once per module in the background
(``torch_dist_worker.start``); the JAX side runs meanwhile, here, through
``make_device_mesh(n)`` of the conftest's 8 virtual devices with the same
n (the ``refs`` fixture). For the Stokes case of the JAX package's
``tests/test_sharding.py`` (P2 x 2 / P1 on ``rectangle(9, 7)`` with the
two-level M at 2 and 4 ranks, with Jacobi and a second right-hand side 2f
at 2, in three spawns: the spawns' budget, see
``torch_dist_worker.sharded_stokes_cases``;
the tet case is in ``test_torch_sharded_tets.py``): every rank's result
equal to rank 0's, the outer iterations and the inner PCG total equal to
JAX's sharded counts, velocities within the JAX test's 1e-10 absolute and
1e-9 relative of JAX's (the outer tolerance is 1e-10: two solves that each
stop there agree to a few times it, 0.2-3.7e-10 measured) and pressures
within JAX's 1e-9 absolute.
"""

import functools
import math
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import make_device_mesh, sharded_stokes_solver
from pytorch_fem_solver_tpu.parallel.sharded_bsr import build_bsr_shard_plan as jax_plan
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.parallel import sharded_bsr as psb
from pytorch_fem_solver_tpu_torch.parallel import sharded_stokes_solver as port_stokes

sys.path.insert(0, str(Path(__file__).parent))
import torch_dist_worker as worker  # noqa: E402

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

WORLDS = (2, 4)
#: (precondition, world) of the rectangle's rank cases
RECTANGLE = (("two_level", 2), ("two_level", 4), ("jacobi", 2))
PLAN_ARRAYS = ("cells_sh", "slots_sh", "bcols_sh", "bcols2_sh", "hrows_sh", "agg_sh",
               "vec_slots_sh", "owned_cells_sh")
PLAN_INTS = ("n_shards", "nb_pad", "rps", "g", "gs", "nc", "nc_local", "ns_local", "nh_max",
             "T_max", "n_values_local")


@pytest.fixture(scope="module", autouse=True)
def runs(tmp_path_factory):
    """The ranks' futures by precondition: the two-level suite at 2 and 4
    ranks and the Jacobi suite at 2, three spawns started together."""
    if len(jax.devices()) < max(WORLDS):
        pytest.skip("needs XLA_FLAGS=--xla_force_host_platform_device_count=8")
    tmp = str(tmp_path_factory.mktemp("stokes"))
    pool, two_level = worker.start("sharded_stokes", tmp, WORLDS)
    pool_j, jacobi = worker.start("sharded_stokes_jacobi", tmp, (2,))
    yield {"two_level": two_level, "jacobi": jacobi}
    pool.shutdown(wait=True)
    pool_j.shutdown(wait=True)


def a_form(b):
    g = b.v_grad
    return jnp.einsum("...icd,...jcd->...ij", g, g)


def div_form(test_p, trial_u):
    div = jnp.trace(trial_u.v_grad, axis1=-2, axis2=-1)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def load_f(b):
    pts = b.integration_points[..., 0, :]
    f = jnp.stack([jnp.sin(math.pi * pts[..., 0]), pts[..., 1] ** 2], axis=-1)
    return (b.v * f[..., None, :]).sum(-1, keepdims=True)


@functools.cache
def rectangle():
    mesh = fem.MeshTri(fem.rectangle(9, 7))
    Vu = fem.VectorBasis(mesh, fem.ElementTri(2, 4))
    return Vu, fem.Basis(mesh, fem.ElementTri(1, 4)), Vu.integrate_linear_form(load_f)


@pytest.fixture(scope="module")
def refs(runs):
    """JAX's sharded solves of every rank case, computed in threads while
    the ranks run: ``(u, p, info)`` by (precondition, world)."""
    Vu, Vp, f = rectangle()

    def solve(pc, world):
        return sharded_stokes_solver(Vu, Vp, a_form, div_form,
                                     device_mesh=make_device_mesh(world), tol=1e-10,
                                     inner_tol=1e-12, precondition=pc)(f)

    return worker.in_threads({key: functools.partial(solve, *key) for key in RECTANGLE})


@pytest.mark.parametrize(("precondition", "world"), RECTANGLE)
def test_sharded_stokes_matches_jax(runs, refs, precondition, world):
    u_ref, p_ref, info_ref = refs[precondition, world]
    res = worker.case(runs[precondition], world, f"stokes_{precondition}")
    assert res["conv"] is bool(info_ref.converged) is True
    assert res["it"] == int(info_ref.outer_iterations)
    assert res["inner_total"] == int(info_ref.inner_total)
    np.testing.assert_allclose(res["u"], np.asarray(u_ref), atol=1e-10)
    assert worker.rel(res["u"], u_ref) <= 1e-9
    np.testing.assert_allclose(res["p"], np.asarray(p_ref), atol=1e-9)
    assert res["type"] == ("int", "int")
    if "u2" in res:  # the second right-hand side 2f, at 2 ranks
        np.testing.assert_allclose(res["u2"], 2.0 * np.asarray(u_ref), atol=1e-9)
        np.testing.assert_allclose(res["p2"], 2.0 * np.asarray(p_ref), atol=2e-9)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_vector_plan_is_byte_identical(n_shards):
    """The plan of the P2 ``VectorBasis`` (the Stokes velocity) equals the
    JAX package's byte for byte."""
    ref = jax_plan(rectangle()[0], n_shards)
    plan = psb.build_bsr_shard_plan(worker.stokes_rectangle()[0], n_shards)
    for name in PLAN_INTS:
        assert getattr(plan, name) == getattr(ref, name), name
    for name in PLAN_ARRAYS:
        ours, theirs = getattr(plan, name), np.asarray(getattr(ref, name))
        assert ours.dtype == theirs.dtype and ours.shape == theirs.shape, name
        assert ours.tobytes() == theirs.tobytes(), name


def test_unknown_names_raise_before_any_table():
    Vu, Vp, _ = worker.stokes_rectangle()
    with pytest.raises(ValueError, match="unknown precondition: 'ilu'"):
        port_stokes(Vu, Vp, worker.stokes_viscous, worker.stokes_div, precondition="ilu")
    with pytest.raises(ValueError, match="unknown matmul_precision: 'bogus'"):
        port_stokes(Vu, Vp, worker.stokes_viscous, worker.stokes_div, matmul_precision="bogus")
    assert Vu not in psb._PLANS and not getattr(Vu, "_bsr_structures", None)
