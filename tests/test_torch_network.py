"""PyTorch port, the VPINN network (``models/network.py``).

The seeded initialisation must hold the JAX network's numbers exactly;
forward, input gradient and Laplacian must agree with the JAX network to
1e-13 in float64 on seeded points, also for weights handed over through
``interop.network_from_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config, interop

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


def _bc(x):
    return x[..., 0:1] * (x[..., 0:1] - 1) * x[..., 1:2] * (x[..., 1:2] - 1)


ARCH = dict(input_dimension=2, output_dimension=1, nb_hidden_layers=3, neurons_per_layers=10)


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(7).uniform(0.05, 0.95, size=(4, 6, 2))


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize(
    "kw",
    [
        {"seed": 0},
        {"seed": 3, "use_xavier_initialization": True},
        {"seed": 5, "final_layer_scale": 0.1},
    ],
)
def test_seeded_init_is_the_jax_init(kw):
    jn = fem.FeedForwardNeuralNetwork(**ARCH, **kw)
    pn = pt.FeedForwardNeuralNetwork(**ARCH, **kw, device="cpu")
    params = dict(pn.named_parameters())
    assert list(params) == [f"{k}{i}" for i in range(5) for k in ("w", "b")]
    for i, (w, b) in enumerate(zip(jn.weights, jn.biases)):
        np.testing.assert_array_equal(params[f"w{i}"].detach().numpy(), np.asarray(w))
        np.testing.assert_array_equal(params[f"b{i}"].detach().numpy(), np.asarray(b))


@pytest.mark.parametrize("via", ["seed", "interop"])
def test_forward_gradient_laplacian_match_jax(points, via):
    jn = fem.FeedForwardNeuralNetwork(**ARCH, boundary_condition_modifier=_bc, seed=11)
    if via == "seed":
        pn = pt.FeedForwardNeuralNetwork(**ARCH, boundary_condition_modifier=_bc, seed=11, device="cpu")
    else:
        pn = interop.network_from_numpy(
            [np.asarray(w) for w in jn.weights], [np.asarray(b) for b in jn.biases],
            **ARCH, boundary_condition_modifier=_bc, seed=99, device="cpu",
        )
    x = torch.tensor(points)
    jx = jnp.asarray(points)
    assert _rel(pn(x).detach(), jn(jx)) <= 1e-13
    assert _rel(pn.gradient(x).detach(), jn.gradient(jx)) <= 1e-13
    assert _rel(pn.laplacian(x).detach(), jn.laplacian(jx)) <= 1e-13


def test_gradient_is_differentiable_in_the_parameters(points):
    """The VPINN double backward: d/dtheta sum(grad_x u) equals JAX's."""
    jn = fem.FeedForwardNeuralNetwork(**ARCH, boundary_condition_modifier=_bc, seed=2)
    pn = pt.FeedForwardNeuralNetwork(**ARCH, boundary_condition_modifier=_bc, seed=2, device="cpu")
    x = torch.tensor(points)
    (pn.gradient(x) ** 2).sum().backward()
    ref = jax.grad(lambda n: (n.gradient(jnp.asarray(points)) ** 2).sum())(jn)
    params = dict(pn.named_parameters())
    for i, (w, b) in enumerate(zip(ref.weights, ref.biases)):
        assert _rel(params[f"w{i}"].grad, w) <= 1e-12
        assert _rel(params[f"b{i}"].grad, b) <= 1e-12


def test_gradient_under_no_grad_keeps_no_graph(points):
    pn = pt.FeedForwardNeuralNetwork(**ARCH, seed=1, device="cpu")
    x = torch.tensor(points)
    with torch.no_grad():
        g = pn.gradient(x)
        lap = pn.laplacian(x)
    assert not g.requires_grad and not lap.requires_grad
    assert torch.equal(g, pn.gradient(x).detach())


def test_with_parameters_and_shape_checks():
    pn = pt.FeedForwardNeuralNetwork(**ARCH, seed=1, device="cpu")
    other = pt.FeedForwardNeuralNetwork(**ARCH, seed=2, device="cpu")
    params = {n: p.detach().numpy() for n, p in other.named_parameters()}
    copy = pn.with_parameters(params)
    for n, p in copy.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), params[n])
    assert not torch.equal(pn.w0, copy.w0)  # the original is unchanged
    with pytest.raises(ValueError, match="expected 5 weights"):
        interop.network_from_numpy(list(pn.weights)[:2], list(pn.biases), **ARCH, device="cpu")
    params["b1"] = params["b1"][:3]
    with pytest.raises(ValueError, match="b1: shape"):
        pn.with_parameters(params)
