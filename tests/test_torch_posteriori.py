"""PyTorch port, the estimator RVPINN (``bench_vpinn.make_posteriori_rvpinn``).

In float64 on the CPU at n=8, against the JAX package's examples on the
same inputs: the RVPINN with the estimator
(``examples/example_weak_plus_posterri.py``) and, with ``weak=False``, the
estimator alone (``examples/example_jump.py``), both built with
``examples/common.py:make_edge_jump``. The loss and every parameter
gradient to 1e-10 (the bulk term holds the network's Laplacian, so the
gradient is a third derivative), and a 5-epoch Adam history against the
JAX ``Model`` to 1e-8. The adaptive DFN loop of the same estimator family
is held in ``test_torch_adaptive.py``.
"""

import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.bench_vpinn import make_posteriori_rvpinn

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

EXAMPLES = pathlib.Path(__file__).resolve().parent.parent / "examples"
N, WIDTH, DEPTH = 8, 8, 2


def _example(name):
    """An example module of the JAX package (its ``main`` is not run)."""
    if str(EXAMPLES) not in sys.path:
        sys.path.insert(0, str(EXAMPLES))
    spec = importlib.util.spec_from_file_location(f"example_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def jax_side():
    """The examples' loss on the JAX package: ``r^T G^{-1} r`` plus the
    bulk and jump terms of ``make_edge_jump`` (example_weak_plus_posterri),
    or the last two alone (example_jump)."""
    common = _example("common")
    mesh = fem.MeshTri(fem.unit_square(n=N))
    V = fem.Basis(mesh, fem.ElementTri(1, 4))
    V_edges = fem.InteriorEdgesBasis(mesh, fem.ElementLine(1, 2))
    jump, h_T, h_E, n_E = common.make_edge_jump(V, V_edges)
    gram_inv = jnp.linalg.inv(V.reduce(V.integrate_bilinear_form(common.stiffness_form)))
    exact_norm = jnp.sqrt(V.integrate_functional(common.h1_exact).sum())

    def bulk(basis, triangle_size, net):
        x, y = common.split_xy(basis.integration_points)
        return triangle_size**2 * (common.rhs(x, y) + net.laplacian(basis.integration_points)) ** 2

    def loss_fn(net, weak):
        estimator = (
            V_edges.integrate_functional(jump, n_E, h_E, net).sum()
            + V.integrate_functional(bulk, h_T, net).sum()
        )
        if not weak:
            return estimator
        r = V.reduce(V.integrate_linear_form(common.residual_form, net.gradient))
        return (r.T @ (gram_inv @ r))[0, 0] + estimator

    def training_step(net, weak):
        loss = loss_fn(net, weak)
        h1 = jnp.sqrt(V.integrate_functional(common.h1_norm, net, net.gradient).sum())
        return loss, jnp.sqrt(loss) / exact_norm**2, h1 / exact_norm

    net = fem.FeedForwardNeuralNetwork(
        2, 1, DEPTH, WIDTH, boundary_condition_modifier=common.boundary_constrain, seed=0
    )
    return net, loss_fn, training_step


def _port(weak, epochs=5, jnet=None):
    run = make_posteriori_rvpinn(N, WIDTH, DEPTH, weak, epochs=epochs, device="cpu")
    if jnet is not None:  # carry the JAX weights across
        net = interop.network_from_numpy(
            [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases],
            input_dimension=2, output_dimension=1, nb_hidden_layers=DEPTH,
            neurons_per_layers=WIDTH, boundary_condition_modifier=run.network.boundary_condition_modifier,
            device="cpu", dtype=torch.float64,
        )
        with torch.no_grad():
            for p, q in zip(run.network.parameters(), net.parameters()):
                p.copy_(q)
    return run


@pytest.mark.parametrize("weak", [True, False])
def test_loss_and_gradients_match_jax(jax_side, weak):
    jnet, loss_fn, training_step = jax_side
    run = _port(weak, jnet=jnet)
    assert run.mesh.n_cells == 2 * N * N
    assert run.edges.integration_points.shape[:2] == (run.mesh.n_interior_edges, 2)
    loss_ref, grads = jax.jit(jax.value_and_grad(lambda n: loss_fn(n, weak)))(jnet)
    loss, relative, acc = run.training_step(run.network)
    assert not relative.requires_grad and not acc.requires_grad
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-10 * abs(float(loss_ref))
    params = dict(run.network.named_parameters())
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad.numpy(), w) <= 1e-10, f"w{i}"
        assert _rel(params[f"b{i}"].grad.numpy(), b) <= 1e-10, f"b{i}"
    _, rel_ref, acc_ref = jax.jit(lambda n: training_step(n, weak))(jnet)
    assert abs(float(relative) - float(rel_ref)) <= 1e-10 * float(rel_ref)
    assert abs(float(acc) - float(acc_ref)) <= 1e-10 * float(acc_ref)
    weak_t, bulk_t, jump_t = (float(t.detach()) for t in run.loss_terms(run.network))
    assert bulk_t > 0 and jump_t > 0 and (weak_t > 0) == weak
    assert abs(weak_t + bulk_t + jump_t - float(loss_ref)) <= 1e-10 * float(loss_ref)


def test_adam_history_matches_jax_model(jax_side):
    jnet, _, training_step = jax_side
    jm = fem.Model(jnet, lambda n: training_step(n, True), epochs=5, progress_bar=False)
    jm.train()
    run = _port(True, jnet=jnet)
    run.model.train()
    for ours, ref in zip(run.model.get_training_history(), jm.get_training_history()):
        assert len(ours) == len(ref) == 5
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0)
    losses = run.model.get_training_history()[0]
    assert losses[-1] < losses[0]


def test_entry_point_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_posteriori_rvpinn(2, 4, 1)
    run = make_posteriori_rvpinn(2, 4, 1, weak=False, device="cpu")
    assert run.gram_inv is None and run.mesh.device.type == "cpu"
