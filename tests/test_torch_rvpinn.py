"""PyTorch port, RVPINN training (``bench_vpinn.make_rvpinn``, ``Model``,
``AbstractBasis`` forms and ``gram_solver``).

The port's RVPINN at ``make_rvpinn(n=8, width=8, depth=2)`` is held against
the same workload built with the JAX package (the repo-root
``bench_vpinn.py`` step) from the same seeded network, in float64 on the
CPU: the Gram assembled from K5's rows against JAX's
``integrate_bilinear_form`` (1e-13), ``gram_solver`` (1e-10, Cholesky and PCG), the loss and
every parameter gradient against ``jax.value_and_grad`` (1e-10), and a
10-epoch Adam history against the JAX ``Model.train`` history (1e-8
relative; optax and torch.optim order Adam's operations differently).
``train_compiled`` must equal ``train`` (the CPU scatter is deterministic),
and the early-stopping and non-finite-guard histories must have the JAX
lengths.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench_vpinn import make_rvpinn

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

N, WIDTH, DEPTH = 8, 8, 2


def _bc(inputs):
    x, y = inputs[..., 0:1], inputs[..., 1:2]
    return x * (x - 1) * y * (y - 1)


def _stiffness(b):
    return b.v_grad @ b.v_grad.mT if isinstance(b.v_grad, torch.Tensor) else (
        b.v_grad @ jnp.matrix_transpose(b.v_grad)
    )


def _jax_rvpinn(n=N, width=WIDTH, depth=DEPTH, seed=0):
    """The repo-root bench_vpinn.py training step, on the JAX package."""
    mesh = fem.MeshTri(fem.unit_square(n=n))
    V = fem.Basis(mesh, fem.ElementTri(1, 4))
    net = fem.FeedForwardNeuralNetwork(2, 1, depth, width, boundary_condition_modifier=_bc, seed=seed)
    gram = V.reduce(V.integrate_bilinear_form(_stiffness))
    gram_inv = jnp.linalg.inv(gram)

    def exact(x, y):
        return jnp.sin(math.pi * x) * jnp.sin(math.pi * y)

    def exact_dx(x, y):
        return math.pi * jnp.cos(math.pi * x) * jnp.sin(math.pi * y)

    def exact_dy(x, y):
        return math.pi * jnp.sin(math.pi * x) * jnp.cos(math.pi * y)

    def h1_exact(basis):
        x, y = basis.integration_points[..., 0:1], basis.integration_points[..., 1:2]
        return exact(x, y) ** 2 + exact_dx(x, y) ** 2 + exact_dy(x, y) ** 2

    exact_norm = jnp.sqrt(jnp.sum(V.integrate_functional(h1_exact)))

    def residual(basis, gradient):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        rhs = 2.0 * math.pi**2 * jnp.sin(math.pi * x) * jnp.sin(math.pi * y)
        return rhs * basis.v - (basis.v_grad @ jnp.matrix_transpose(gradient(pts)))

    def h1_norm(basis, net, gradient):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        g = gradient(pts)
        return (
            (exact(x, y) - net(pts)) ** 2
            + (exact_dx(x, y) - g[..., 0:1]) ** 2
            + (exact_dy(x, y) - g[..., 1:2]) ** 2
        )

    def loss_fn(net):
        r = V.reduce(V.integrate_linear_form(residual, net.gradient))
        return (r.T @ (gram_inv @ r))[0, 0]

    def training_step(net):
        loss = loss_fn(net)
        relative = jnp.sqrt(loss) / exact_norm**2
        h1_err = jnp.sqrt(jnp.sum(V.integrate_functional(h1_norm, net, net.gradient)))
        return loss, relative, h1_err / exact_norm

    return V, net, gram, loss_fn, training_step


@pytest.fixture(scope="module")
def jax_side():
    return _jax_rvpinn()


def _port(epochs=10, **kw):
    return make_rvpinn(N, WIDTH, DEPTH, epochs=epochs, device="cpu", **kw)


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_k5_gram_equals_jax_gram(jax_side):
    _, _, gram, _, _ = jax_side
    r = _port()
    assert r.mesh.n_cells == 2 * N * N and r.basis.integration_points.shape[1] == 6
    ours = torch.linalg.inv(r.gram_inv)
    assert _rel(ours.numpy(), gram) <= 1e-12
    from pytorch_fem_solver_tpu_torch.ops.kernels import p1_local_stiffness_load

    stiff, _, _ = p1_local_stiffness_load(r.mesh["cells", "coordinates"])
    k5_gram = r.basis.reduce(r.basis._assemble_bilinear_from_local(stiff))
    assert _rel(k5_gram.numpy(), gram) <= 1e-13
    assert _rel(r.basis.reduce(r.basis.integrate_bilinear_form(_stiffness)).numpy(), gram) <= 1e-13


def test_gram_solver_matches_jax(jax_side):
    V, _, _, _, _ = jax_side
    r = _port()
    rhs = np.random.default_rng(0).standard_normal((V._basis_parameters["inner_dofs"].shape[0], 1))
    ref = V.gram_solver(_stiffness, method="cholesky")(jnp.asarray(rhs))
    solve = r.basis.gram_solver(_stiffness)
    assert _rel(solve(torch.tensor(rhs)).numpy(), ref) <= 1e-10
    assert _rel(solve(torch.tensor(rhs[:, 0])).numpy(), np.asarray(ref)[:, 0]) <= 1e-10
    pcg = r.basis.gram_solver(_stiffness, method="pcg")
    assert _rel(pcg(torch.tensor(rhs)).numpy(), ref) <= 1e-10
    assert _rel(pcg(torch.tensor(rhs[:, 0])).numpy(), np.asarray(ref)[:, 0]) <= 1e-10


def test_linear_and_functional_forms_match_jax(jax_side):
    V, _, _, _, _ = jax_side
    r = _port()
    load = r.basis.integrate_linear_form(lambda b: b.v * b.integration_points[..., :1])
    ref = V.integrate_linear_form(lambda b: b.v * b.integration_points[..., :1])
    assert _rel(load.numpy(), ref) <= 1e-13
    area = r.basis.integrate_functional(lambda b: b.integration_points[..., :1] ** 2)
    ref = V.integrate_functional(lambda b: b.integration_points[..., :1] ** 2)
    assert _rel(area.numpy(), ref) <= 1e-13


def test_loss_and_gradients_match_jax(jax_side):
    _, jnet, _, loss_fn, training_step = jax_side
    r = _port()
    loss_ref, grads = jax.value_and_grad(loss_fn)(jnet)
    loss, relative, acc = r.training_step(r.network)
    assert not relative.requires_grad and not acc.requires_grad
    loss.backward()
    loss = loss.detach()
    assert abs(float(loss) - float(loss_ref)) <= 1e-10 * abs(float(loss_ref))
    params = dict(r.network.named_parameters())
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad.numpy(), w) <= 1e-10
        assert _rel(params[f"b{i}"].grad.numpy(), b) <= 1e-10
    _, rel_ref, acc_ref = training_step(jnet)
    assert abs(float(relative) - float(rel_ref)) <= 1e-10 * float(rel_ref)
    assert abs(float(acc) - float(acc_ref)) <= 1e-10 * float(acc_ref)


def test_adam_history_matches_jax_model(jax_side):
    _, jnet, _, _, training_step = jax_side
    jm = fem.Model(jnet, training_step, epochs=10, progress_bar=False)
    jm.train()
    r = _port()
    r.model.train()
    for ours, ref in zip(r.model.get_training_history(), jm.get_training_history()):
        assert len(ours) == len(ref) == 10
        np.testing.assert_allclose(ours, ref, rtol=1e-8, atol=0)
    assert r.model.get_training_history()[0][-1] < r.model.get_training_history()[0][0]


def test_train_compiled_equals_train():
    eager, blocked = _port(), _port()
    eager.model.train()
    blocked.model.train_compiled(block_size=3)
    for a, b in zip(eager.model.get_training_history(), blocked.model.get_training_history()):
        assert len(a) == len(b) == 10
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
    for p, q in zip(eager.network.parameters(), blocked.network.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), rtol=0, atol=1e-12)
    for n, p in eager.model.optimal_parameters.items():
        np.testing.assert_allclose(
            p.numpy(), blocked.model.optimal_parameters[n].numpy(), rtol=0, atol=1e-12
        )


def _tiny(fem_pkg, seed, diverge=False, **model_kwargs):
    """The JAX tests' tiny example_weak model (unit_square(6), P1, order 3),
    built with either package; with ``diverge`` every loss is infinite."""
    is_port = fem_pkg is pt
    kw = {"device": "cpu"} if is_port else {}
    mesh = fem_pkg.MeshTri(fem_pkg.unit_square(n=6) if is_port else fem.unit_square(n=6), **kw)
    V = fem_pkg.Basis(mesh, fem_pkg.ElementTri(1, 3))
    inv = torch.linalg.inv if is_port else jnp.linalg.inv
    gram_inv = inv(V.reduce(V.integrate_bilinear_form(_stiffness)))
    sin = torch.sin if is_port else jnp.sin

    def residual(basis, gradient):
        pts = basis.integration_points
        x, y = pts[..., 0:1], pts[..., 1:2]
        g = gradient(pts)
        gt = g.mT if is_port else jnp.matrix_transpose(g)
        return 2.0 * math.pi**2 * sin(math.pi * x) * sin(math.pi * y) * basis.v - basis.v_grad @ gt

    def training_step(net):
        r = V.reduce(V.integrate_linear_form(residual, net.gradient))
        loss = (r.T @ (gram_inv @ r))[0, 0]
        return (loss + math.inf if diverge else loss), loss, loss

    net = fem_pkg.FeedForwardNeuralNetwork(2, 1, 2, 8, boundary_condition_modifier=_bc, seed=seed, **kw)
    return fem_pkg.Model(net, training_step, progress_bar=False, **model_kwargs)


def test_early_stopping_histories_have_the_jax_length():
    kw = dict(epochs=200, use_early_stopping=True, early_stopping_patience=4, min_delta=5e-1)
    ref = _tiny(fem, 3, **kw)
    ref.train()
    n_ref = len(ref.get_training_history()[0])
    assert n_ref < 200
    eager = _tiny(pt, 3, **kw)
    eager.train()
    blocked = _tiny(pt, 3, **kw)
    blocked.train_compiled(block_size=17)
    for m in (eager, blocked):
        hist = m.get_training_history()[0]
        assert len(hist) == n_ref
        np.testing.assert_allclose(hist, ref.get_training_history()[0], rtol=1e-8)
    # the block ran past the stop and was re-run: the snapshot and the live
    # network are those of the eager loop
    for n, p in eager.optimal_parameters.items():
        assert torch.equal(p, blocked.optimal_parameters[n])
    for n, q in blocked.neural_network.named_parameters():
        assert torch.equal(q, blocked.optimal_parameters[n])
    # impossible improvement: stops after `patience` epochs, as JAX does
    kw = dict(epochs=200, use_early_stopping=True, early_stopping_patience=3, min_delta=1e30)
    ref, ours = _tiny(fem, 0, **kw), _tiny(pt, 0, **kw)
    ref.train()
    ours.train()
    assert len(ours.get_training_history()[0]) == len(ref.get_training_history()[0]) <= 4


def test_non_finite_guard_histories_have_the_jax_length():
    kw = dict(epochs=30, diverge=True)
    ref = _tiny(fem, 1, **kw)
    ref.train()
    eager = _tiny(pt, 1, **kw)
    start = {n: p.clone() for n, p in eager.neural_network.named_parameters()}
    eager.train()
    assert len(eager.get_training_history()[0]) == len(ref.get_training_history()[0]) == 11
    for n, p in eager.neural_network.named_parameters():
        assert torch.equal(p, start[n])  # held at the (initial) snapshot
    ref_blocked = _tiny(fem, 1, **kw)
    ref_blocked.train_compiled(block_size=4)
    blocked = _tiny(pt, 1, **kw)
    blocked.train_compiled(block_size=4)
    assert len(blocked.get_training_history()[0]) == len(ref_blocked.get_training_history()[0]) == 12
    for n, p in blocked.neural_network.named_parameters():
        assert torch.isfinite(p).all() and torch.equal(p, start[n])


def test_checkpoint_round_trip_resumes_the_trajectory(tmp_path):
    straight = _port(epochs=6)
    straight.model.train()
    first = _port(epochs=3)
    first.model.train()
    path = str(tmp_path / "resume.npz")
    first.model.save_checkpoint(path)
    second = _port(epochs=3)
    second.model.load_checkpoint(path)
    assert second.model.get_training_history()[0] == first.model.get_training_history()[0]
    second.model.train()
    hist = second.model.get_training_history()[0]
    assert hist[-3:] == straight.model.get_training_history()[0][3:]
    for p, q in zip(second.network.parameters(), straight.network.parameters()):
        assert torch.equal(p, q)
    wider = make_rvpinn(N, WIDTH + 1, DEPTH, epochs=1, device="cpu")
    with pytest.raises(ValueError, match="architecture"):
        wider.model.load_checkpoint(path)


def test_unported_options_raise():
    r = _port()
    # the plateau scheduler is ported now (tests/test_torch_scheduler.py):
    # accepted, with its state on the network's device
    m = pt.Model(r.network, r.training_step, learning_rate_scheduler="reduce_on_plateau")
    assert m._scheduler.state["scale"].device == r.network.w0.device
    assert m._optimizer.param_groups[0]["lr"] is m._lr and float(m._lr) == 1e-3
    m = pt.Model(r.network, r.training_step, optimizer_kwargs={"learning_rate": 0.5})
    assert m._optimizer.param_groups[0]["lr"] == 0.5
