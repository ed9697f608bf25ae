"""PyTorch port, the seven-fracture DFN RVPINN
(``bench_vpinn.make_dfn_rvpinn``) against the JAX package's
``examples/example_seven_fractures_vpinn.py`` at the settings of
``tools/exp_dfn_vpinn_epoch.py``, in float64 on the CPU at h=0.25 (3,216
cells, 1,587 DOFs, so the Gram PCG builds its two-level preconditioner).

The seeded networks hold the same weights in both packages. The oracle
(``solve_iterative`` on the BSR operator with the aggregate two-level M)
takes the JAX iteration count and agrees to 1e-9; its interpolation and H1
norm to 1e-12; 5 epochs of the warm-started (stateful) ``Model`` agree with
the JAX ``Model`` in loss, relative weak norm and H1 distance within 1e-8
relative, and the cold start (no state) with the warm one within 1e-8.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench_vpinn import BC_WEIGHT, make_dfn_rvpinn

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

H = 0.25
EPOCHS = 5


def _jax_dfn_rvpinn(h=H, epochs=EPOCHS):
    """The JAX example's workload with the pcg Gram and its warm start."""
    mesh = jax_network(h=h)
    V = fem.FractureNetworkBasis(mesh, fem.ElementTri(1, 2))
    a_form = lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad)  # noqa: E731
    u_fem, info = V.solve_iterative(
        V.integrate_bilinear_form_local(a_form), V.integrate_linear_form(lambda b: b.v),
        tol=1e-6, precondition="two_level", return_info=True,
    )
    I_fem, I_fem_grad = V.interpolate(V, u_fem)
    fem_norm = jnp.sqrt(V.integrate_functional(
        lambda b, u, g: u**2 + (g**2).sum(-1, keepdims=True), I_fem, I_fem_grad
    ).sum())
    nn = fem.FeedForwardNeuralNetwork(
        input_dimension=3, output_dimension=1, nb_hidden_layers=4,
        neurons_per_layers=24, final_layer_scale=0.05,
    )
    markers = np.asarray(mesh["global", "markers"])[:, 0]
    boundary_nodes = jnp.asarray(np.asarray(mesh["global", "vertices_3d"])[markers == 1])
    gram_solve = V.gram_solver(a_form, method="pcg")

    def residual(basis, net):
        pts = basis.integration_points
        return basis.v - (basis.v_grad @ jnp.matrix_transpose(net.gradient(pts)))

    def h1_error_vs_fem(basis, net):
        pts = basis.integration_points
        cell_frac = basis.mesh["cells", "fracture"][:, 0]
        jac = basis.mesh["fracture_map", "jacobian"][cell_frac][:, None]
        inv = basis.mesh["fracture_map", "inv_jacobian"][cell_frac][:, None]
        tangent = net.gradient(pts) @ (jac @ inv)
        return (net(pts) - I_fem) ** 2 + ((tangent - I_fem_grad) ** 2).sum(-1, keepdims=True)

    def training_step(net, x_prev):
        r = V.reduce(V.integrate_linear_form(residual, net))
        x = gram_solve(r, x_prev)
        weak = (r.T @ x)[0, 0]
        loss = weak + BC_WEIGHT * jnp.mean(net(boundary_nodes) ** 2)
        h1 = jnp.sqrt(V.integrate_functional(h1_error_vs_fem, net).sum())
        return (loss, jnp.sqrt(weak) / fem_norm, h1 / fem_norm), x

    state0 = jnp.zeros(V.reduce(jnp.zeros((V.n_dofs, 1))).shape)
    model = fem.Model(nn, training_step, epochs=epochs, optimizer_kwargs={"lr": 1e-3},
                      training_state0=state0, progress_bar=False)
    return V, u_fem, info, I_fem, I_fem_grad, fem_norm, nn, model


@pytest.fixture(scope="module")
def jax_side():
    return _jax_dfn_rvpinn()


@pytest.fixture(scope="module")
def warm():
    return make_dfn_rvpinn(H, epochs=EPOCHS, device="cpu")


def _rel(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def test_oracle_interpolation_and_norm_match_jax(jax_side, warm):
    V, u_fem, info, I_fem, I_fem_grad, fem_norm, nn, _ = jax_side
    assert (warm.mesh.n_cells, warm.basis.n_dofs) == (3216, 1587)
    assert warm.oracle_info.iterations == int(info.iterations)
    assert bool(warm.oracle_info.converged)
    assert _rel(warm.u_fem, u_fem) <= 1e-9
    ours, ours_grad = warm.basis.interpolate(warm.basis, warm.u_fem)
    assert _rel(ours, I_fem) <= 1e-9 and _rel(ours_grad, I_fem_grad) <= 1e-9
    assert abs(float(warm.fem_norm) - float(fem_norm)) <= 1e-9 * float(fem_norm)
    for i, (w, b) in enumerate(zip(nn.weights, nn.biases)):
        assert np.array_equal(getattr(warm.network, f"w{i}").detach().numpy(), np.asarray(w))
        assert np.array_equal(getattr(warm.network, f"b{i}").detach().numpy(), np.asarray(b))
    assert warm.boundary_nodes.shape[1] == 3 and warm.boundary_nodes.shape[0] > 0


def test_five_warm_epochs_match_the_jax_model(jax_side, warm):
    model = jax_side[-1]
    model.train()
    warm.model.train()
    for ours, ref in zip(warm.model.get_training_history(), model.get_training_history()):
        assert len(ours) == len(ref) == EPOCHS
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0)
    losses = warm.model.get_training_history()[0]
    assert losses[-1] < losses[0]
    # the Gram iterate rode the epochs: every warm forward solve after the
    # first starts closer and takes fewer iterations; every backward exits
    # at once from its a x seed
    fwd, back = warm.gram_solve.iterations["forward"], warm.gram_solve.iterations["backward"]
    assert len(fwd) == len(back) == EPOCHS
    assert max(fwd[1:]) < fwd[0] and max(back) <= 1
    assert _rel(warm.model._training_state, model._training_state) <= 1e-8


def test_cold_start_matches_the_warm_start(warm):
    cold = make_dfn_rvpinn(H, warm=False, epochs=EPOCHS, mesh=warm.mesh, device="cpu")
    cold.model.train_compiled(EPOCHS)
    if not warm.model.get_training_history()[0]:
        warm.model.train()
    for ours, ref in zip(cold.model.get_training_history(), warm.model.get_training_history()):
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0)
    assert len(set(cold.gram_solve.iterations["forward"])) == 1  # every solve from zero
    with pytest.raises(ValueError, match="gram='pcg'"):
        make_dfn_rvpinn(H, gram="cholesky", mesh=warm.mesh, device="cpu")
