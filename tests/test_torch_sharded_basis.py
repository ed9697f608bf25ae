"""PyTorch port, ``parallel/sharding.py:shard_basis_cells`` against the JAX
package in float64.

The port's ranks are gloo processes on the CPU, 2 and 4 of them, spawned
once per module in the background (``torch_dist_worker.start``); each test
reads its own case. The JAX side shards the same basis over
``make_device_mesh(n)`` of the conftest's 8 virtual devices. Held, for the
cases of the JAX package's ``tests/test_sharding.py``: the VPINN loss on
the shard copy within 1e-10 (relative) of JAX's sharded loss, and the
parameter gradients, averaged over the group, within 1e-10 of JAX's; the
padded cell count, each rank's chunk and the per-cell functional's shape
(the whole padded axis) equal JAX's, areas to 1e-12; a cell count that
divides neither 2 nor 4 (49 cells), and the fracture basis padded along
its per-fracture cell axis with the load vector equal to JAX's to 1e-12.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.parallel import make_device_mesh, shard_basis_cells
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
    pool, futures = worker.start("sharded_basis", str(tmp_path_factory.mktemp("basis")), WORLDS)
    yield futures
    pool.shutdown(wait=True)


def load(b):
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return (1.0 + x + y) * b.v


def jax_vpinn(V, world, arch, bc):
    """The JAX test's VPINN loss and gradients on the JAX shard of V."""
    V_sh = shard_basis_cells(V, make_device_mesh(world))
    net = fem.FeedForwardNeuralNetwork(*arch, boundary_condition_modifier=bc)

    def residual(basis, gradient):
        return basis.v - basis.v_grad @ jnp.matrix_transpose(gradient(basis.integration_points))

    def loss_fn(n, basis):
        r = basis.reduce(basis.integrate_linear_form(residual, n.gradient))
        return jnp.sum(r**2)

    loss = float(jax.jit(loss_fn)(net, V_sh))
    grads = jax.jit(jax.grad(loss_fn))(net, V_sh)
    return V_sh, loss, grads, V_sh.integrate_functional(lambda b: b.v)


def check_vpinn(runs, world, name, V, arch, bc):
    V_sh, loss, grads, per_cell = jax_vpinn(V, world, arch, bc)
    res = worker.case(runs, world, name)
    n_cells = int(V.integration_points.shape[0])
    n_pad = int(V_sh.integration_points.shape[0])
    assert n_pad == -(-n_cells // world) * world
    assert res["shape"] == (n_pad // world,) + tuple(V.integration_points.shape[1:])
    assert res["per_cell"] == per_cell.shape  # the whole padded cell axis
    assert abs(res["area"] - float(per_cell.sum())) <= 1e-12
    assert abs(res["loss"] - loss) <= 1e-10 * max(1.0, abs(loss))
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        for key, ref in ((f"w{i}", w), (f"b{i}", b)):
            ref = np.asarray(ref)
            assert np.abs(res["grads"][key] - ref).max() <= 1e-10 * max(1.0, np.abs(ref).max())
    return res


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_basis_training_step(runs, world):
    """The VPINN loss on the cell-sharded basis and its group-averaged
    gradients equal JAX's."""
    V = fem.Basis(fem.MeshTri(fem.unit_square(n=8)), fem.ElementTri(1, 2))
    check_vpinn(runs, world, "training_step", V, (2, 1, 2, 8), worker.bc)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_basis_pads_non_divisible_cell_count(runs, world):
    """49 cells over 2 and 4 ranks: padded, sharded, every integral exact
    (the area is the 49 cells' 0.98)."""
    V = fem.Basis(fem.MeshTri(worker.odd_square_mesh(fem.unit_square)), fem.ElementTri(1, 2))
    assert V.integration_points.shape[0] % world != 0
    res = check_vpinn(runs, world, "pads_non_divisible", V, (2, 1, 1, 6), None)
    assert abs(res["area"] - 0.98) < 1e-12


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_batched_basis_pads_and_shards(runs, world):
    """The fracture basis (cells behind a batch axis, 30 per fracture):
    padded along the per-fracture cell axis as JAX pads it, total area
    exact, the assembled load vector equal to JAX's (1e-12); the shard copy
    drops the basis's layout caches, and a gloo rank's device is the CPU."""
    tri = fem.rectangle(5, 3, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    dfn = fem.FracturesTri([tri, tri], worker.FRACTURES_3D, anchor_vertices_2d=worker.ANCHORS)
    V = fem.FractureBasis(dfn, fem.ElementTri(1, 2))
    V_sh = shard_basis_cells(V, make_device_mesh(world))
    b_ref = np.asarray(V.integrate_linear_form(load))
    res = worker.case(runs, world, "batched_pads")
    chunk = int(V_sh.integration_points.shape[1]) // world
    assert chunk == -(-int(V.integration_points.shape[1]) // world)
    for shape, arr in zip(res["shapes"], (V_sh.v_grad, V_sh.integration_points, V_sh._dx)):
        assert shape == (arr.shape[0], chunk) + tuple(arr.shape[2:])
    assert abs(res["area"] - 4.0) < 1e-12
    np.testing.assert_allclose(res["b"], b_ref, atol=1e-12)
    assert res["caches"] == [] and res["device"] == "cpu"
