"""PyTorch port, the 3D RVPINN (``bench_vpinn.make_vpinn_3d``).

``examples/example_vpinn_3d.py``'s training step is rebuilt here from the
JAX package's public API (``MeshTet(unit_cube(n))``, ``ElementTet(1, 3)``,
``gram_solver(stiffness, method=gram)``, the ``x(x-1)y(y-1)z(z-1)``
modifier, the manufactured ``sin(πx) sin(πy) sin(πz)``) and trained 10
epochs by the JAX ``Model`` with Adam at 1e-3; the port's
``make_vpinn_3d(n, gram)`` trains the same seeded network (its weights
equal, bitwise, to the JAX network's carried over by
``interop.network_from_numpy``). The loss, relative-loss and relative-H1
histories agree to 1e-10 relative in float64 on the CPU, for
``gram="cholesky"`` and ``gram="pcg"``, at n=3 (8 inner
DOFs, point Jacobi) and for ``"pcg"`` at the example's n=8 as well (343
inner DOFs, the two-level M). The first loss and its parameter gradients
agree to 1e-10 against ``jax.value_and_grad``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.element import ElementTet
from pytorch_fem_solver_tpu.mesh import MeshTet, unit_cube
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.bench_vpinn import make_vpinn_3d

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

EPOCHS = 10
PI = math.pi


def _bc(inputs):
    x, y, z = inputs[..., 0:1], inputs[..., 1:2], inputs[..., 2:3]
    return x * (x - 1) * y * (y - 1) * z * (z - 1)


def _exact(p):
    return jnp.sin(PI * p[..., 0:1]) * jnp.sin(PI * p[..., 1:2]) * jnp.sin(PI * p[..., 2:3])


def _grad_exact(p):
    s, c = jnp.sin, jnp.cos
    x, y, z = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    return jnp.concatenate(
        [
            PI * c(PI * x) * s(PI * y) * s(PI * z),
            PI * s(PI * x) * c(PI * y) * s(PI * z),
            PI * s(PI * x) * s(PI * y) * c(PI * z),
        ],
        axis=-1,
    )


def _jax_example(n, gram, seed=0):
    """``examples/example_vpinn_3d.py`` at FEM_N=n, FEM_GRAM=gram: the
    network, the training step and its loss function."""
    net = fem.FeedForwardNeuralNetwork(3, 1, 4, 20, boundary_condition_modifier=_bc, seed=seed)
    V = fem.Basis(MeshTet(unit_cube(n)), ElementTet(1, integration_order=3))
    gram_solve = V.gram_solver(lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad), method=gram)
    exact_norm = jnp.sqrt(V.integrate_functional(
        lambda b: _exact(b.integration_points) ** 2
        + (_grad_exact(b.integration_points) ** 2).sum(-1, keepdims=True)).sum())

    def residual(b, gradient):
        pts = b.integration_points
        return 3 * PI**2 * _exact(pts) * b.v - b.v_grad @ jnp.matrix_transpose(gradient(pts))

    def h1_norm(b, nn, gradient):
        pts = b.integration_points
        return (_exact(pts) - nn(pts)) ** 2 + (
            (_grad_exact(pts) - gradient(pts)) ** 2).sum(-1, keepdims=True)

    def loss_fn(nn):
        r = V.reduce(V.integrate_linear_form(residual, nn.gradient))
        return (r.T @ gram_solve(r))[0, 0]

    def training_step(nn):
        loss = loss_fn(nn)
        h1 = jnp.sqrt(V.integrate_functional(h1_norm, nn, nn.gradient).sum())
        return loss, jnp.sqrt(loss) / exact_norm**2, h1 / exact_norm

    return net, training_step, loss_fn


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("n, gram", [(3, "cholesky"), (3, "pcg"), (8, "pcg")])
def test_histories_match_the_jax_example(n, gram):
    jnet, step, _ = _jax_example(n, gram)
    ref = fem.Model(jnet, step, epochs=EPOCHS, optimizer_kwargs={"lr": 0.001}, progress_bar=False)
    ref.train()
    ours = make_vpinn_3d(n, gram, epochs=EPOCHS, device="cpu")
    assert ours.mesh.n_cells == 6 * n**3
    assert ours.basis.integration_points.shape[1] == 5  # tetrahedron_rule(3)
    ours.model.train()
    for a, b in zip(ours.model.get_training_history(), ref.get_training_history()):
        assert len(a) == len(b) == EPOCHS
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=0)
    losses = ours.model.get_training_history()[0]
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("gram", ["cholesky", "pcg"])
def test_seeded_network_loss_and_gradients_match_jax(gram):
    jnet, step, loss_fn = _jax_example(3, gram, seed=5)
    ours = make_vpinn_3d(3, gram, epochs=1, seed=5, device="cpu")
    carried = interop.network_from_numpy(
        [np.asarray(w) for w in jnet.weights], [np.asarray(b) for b in jnet.biases],
        input_dimension=3, output_dimension=1, nb_hidden_layers=4, neurons_per_layers=20,
        device="cpu", dtype=torch.float64,
    )
    params = dict(ours.network.named_parameters())
    for name, p in carried.named_parameters():
        assert torch.equal(p, params[name])  # the seeded draw is JAX's
    loss_ref, grads = jax.value_and_grad(loss_fn)(jnet)
    loss, relative, h1 = ours.training_step(ours.network)
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(loss_ref)) <= 1e-10 * abs(float(loss_ref))
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad.numpy(), w) <= 1e-10
        assert _rel(params[f"b{i}"].grad.numpy(), b) <= 1e-10
    _, rel_ref, h1_ref = step(jnet)
    assert abs(float(relative) - float(rel_ref)) <= 1e-10 * float(rel_ref)
    assert abs(float(h1) - float(h1_ref)) <= 1e-10 * float(h1_ref)
    assert not relative.requires_grad and not h1.requires_grad
