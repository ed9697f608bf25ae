"""PyTorch port, the matrix-free PCG Gram solver
(``AbstractBasis.gram_solver(method="pcg")``) and the stateful training
protocol (``Model(training_state0=...)``).

In float64 on the CPU, against the JAX package:

* ``gram_solver("pcg")`` forward on the h=0.25 seven-fracture DFN (1,587
  DOFs: the smoothed two-level M is built) and on a unit square (49 inner
  DOFs, under 256: point Jacobi), cold and warm, with the iteration count
  of the JAX solve (whose loop is the JAX ``pcg`` on the JAX ELL operator
  and preconditioner, replayed here to read its count) and the solution
  within 1e-12;
* gradients of ``r^T G^{-1} r`` with respect to ``r`` and to the network's
  parameters equal to ``jax.grad`` within 1e-8 relative, and the backward
  solve, seeded with ``a x``, in the JAX backward's iteration count;
* ``Model(training_state0=...)``: 10 epochs of ``train()`` and of
  ``train_compiled(5)`` within 1e-8 of the JAX ``Model``, warm within 1e-8
  of cold, and a non-finite epoch resetting the state in both loops.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops import solvers as jsol
from pytorch_fem_solver_tpu.ops import sparse as js
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.basis.abstract_basis import GramPCG

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

TOL = 1e-12


def _stiffness(b):
    if isinstance(b.v_grad, torch.Tensor):
        return b.v_grad @ b.v_grad.mT
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def _bases(mesh):
    if mesh == "dfn":
        jm = jax_network(h=0.25)
        pm = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jm._t), device="cpu")
        return (
            fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2)),
            pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2)),
        )
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(n=8)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.unit_square(n=8), device="cpu"), pt.ElementTri(1, 2)),
    )


def _jax_gram_loop(jV, tol):
    """``run(b, x0) -> (x, iterations)``: the loop inside the JAX
    ``gram_solver(method="pcg")``, on its operator and preconditioner."""
    st = js.get_ell_structure(jV, max_k=8)
    values = js.ell_values_from_local(st, jV.integrate_bilinear_form_local(_stiffness))
    diag = js.ell_diagonal(st, values)
    n = st.n_inner
    precond = None
    if n >= 256:
        coords = np.asarray(jV._coords4global_dofs)[np.asarray(jV._basis_parameters["inner_dofs"])]
        tl = jp.build_two_level_structure(st, coords, leaf=32, kp=4)
        precond = jp.two_level_from_values(tl, st, values, diag)

    def run(b, x0):
        x, info = jsol.pcg(
            lambda v: js.ell_matvec(st, values, v), b, x0=x0, precond=precond,
            precond_diag=None if precond is not None else diag, tol=tol,
            maxiter=max(10 * n, 100),
        )
        return np.asarray(x), int(info.iterations)

    return run


@pytest.fixture(scope="module", params=["dfn", "square"])
def gram(request):
    jV, pV = _bases(request.param)
    solve = pV.gram_solver(_stiffness, method="pcg")
    assert isinstance(solve, GramPCG) and solve.tol == TOL
    assert (solve.precond is not None) == (request.param == "dfn")
    return jV, pV, solve, _jax_gram_loop(jV, TOL)


def _rel(ours, ref):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _rhs(pV, seed):
    n = int(pV._basis_parameters["inner_dofs"].shape[0])
    return np.random.default_rng(seed).standard_normal((n, 1))


@pytest.mark.parametrize("start", ["cold", "warm"])
def test_forward_matches_jax_with_its_iteration_count(gram, start):
    jV, pV, solve, jax_loop = gram
    r = _rhs(pV, 0)
    x0 = np.zeros_like(r) if start == "cold" else _jax_gram_loop(jV, 1e-3)(
        jnp.asarray(r[:, 0] + 0.01 * _rhs(pV, 1)[:, 0]), None
    )[0][:, None]
    x_ref, iters_ref = jax_loop(jnp.asarray(r[:, 0]), jnp.asarray(x0[:, 0]))
    solve.iterations["forward"].clear()
    x = solve(torch.from_numpy(r), torch.from_numpy(np.array(x0)))
    assert x.shape == r.shape
    assert solve.iterations["forward"] == [iters_ref]
    assert _rel(x[:, 0], x_ref) <= 1e-12
    # the JAX package's own solver gives the same answer
    x_jax = jV.gram_solver(_stiffness, method="pcg")(jnp.asarray(r), jnp.asarray(x0))
    assert _rel(x, x_jax) <= 1e-12
    if start == "warm" and pV.n_dofs == 1587:
        # the warm start pays on the DFN (on the 49-DOF square CG takes the
        # same count from either start)
        cold = pV.gram_solver(_stiffness, method="pcg")
        cold(torch.from_numpy(r))
        assert cold.iterations["forward"][0] > iters_ref


def test_flat_input_keeps_its_shape_and_x0_gets_no_gradient(gram):
    _, pV, solve, _ = gram
    r = torch.from_numpy(_rhs(pV, 2)[:, 0]).requires_grad_()
    x0 = torch.zeros_like(r).requires_grad_()
    x = solve(r, x0)
    assert x.shape == r.shape and x.requires_grad
    (x * x).sum().backward()
    assert r.grad is not None and x0.grad is None


def test_gradient_in_r_and_the_backward_seed_match_jax(gram):
    jV, pV, solve, jax_loop = gram
    r = _rhs(pV, 3)
    j_solve = jV.gram_solver(_stiffness, method="pcg")
    g_ref = jax.grad(lambda v: (v.T @ j_solve(v))[0, 0])(jnp.asarray(r))
    rt = torch.from_numpy(r).requires_grad_()
    for direction in ("forward", "backward"):
        solve.iterations[direction].clear()
    (rt.T @ solve(rt))[0, 0].backward()
    assert _rel(rt.grad, g_ref) <= 1e-8
    # the backward's count: the JAX loop seeded with a x, a = <r, x>/<r, x>
    x, _ = jax_loop(jnp.asarray(r[:, 0]), jnp.zeros(r.shape[0]))
    a = float(r[:, 0] @ x) / float(r[:, 0] @ x)
    _, back_ref = jax_loop(jnp.asarray(r[:, 0]), jnp.asarray(a * x))
    assert solve.iterations["backward"] == [back_ref]
    assert back_ref <= 1 < solve.iterations["forward"][0]


def test_backward_with_a_cotangent_not_parallel_to_r(gram):
    """``a`` then only scales the seed: the pullback is still G^{-1} c."""
    jV, pV, solve, _ = gram
    r, c = _rhs(pV, 4), _rhs(pV, 5)
    j_solve = jV.gram_solver(_stiffness, method="pcg")
    ref = jax.vjp(j_solve, jnp.asarray(r))[1](jnp.asarray(c))[0]
    rt = torch.from_numpy(r).requires_grad_()
    solve(rt).backward(torch.from_numpy(c))
    assert _rel(rt.grad, ref) <= 1e-8
    # a zero r gives x = 0 and <r, x> = 0: the seed is 0 (a = 0), no NaN
    z = torch.zeros_like(rt).requires_grad_()
    solve(z).backward(torch.from_numpy(c))
    assert bool(torch.isfinite(z.grad).all())
    assert _rel(z.grad, j_solve(jnp.asarray(c))) <= 1e-8


def _bc(x):
    return x[..., 0:1] * (x[..., 0:1] - 1) * x[..., 1:2] * (x[..., 1:2] - 1)


def _residual(b, gradient):
    g = gradient(b.integration_points)
    gt = g.mT if isinstance(g, torch.Tensor) else jnp.matrix_transpose(g)
    return b.v - b.v_grad @ gt


def test_gradient_in_the_network_parameters_matches_jax():
    """The RVPINN loss r^T G^{-1} r on the h=0.25 DFN (two-level M), 3D
    network, against ``jax.grad``."""
    jV, pV = _bases("dfn")
    j_solve = jV.gram_solver(_stiffness, method="pcg")
    solve = pV.gram_solver(_stiffness, method="pcg")
    arch = dict(input_dimension=3, output_dimension=1, nb_hidden_layers=2,
                neurons_per_layers=8, final_layer_scale=0.05, seed=1)
    jnet = fem.FeedForwardNeuralNetwork(**arch)
    net = pt.FeedForwardNeuralNetwork(**arch, device="cpu")

    def jloss(n):
        r = jV.reduce(jV.integrate_linear_form(_residual, n.gradient))
        return (r.T @ j_solve(r))[0, 0]

    loss_ref, grads = jax.value_and_grad(jloss)(jnet)
    r = pV.reduce(pV.integrate_linear_form(_residual, net.gradient))
    loss = (r.T @ solve(r))[0, 0]
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_ref)) <= 1e-10 * abs(float(loss_ref))
    params = dict(net.named_parameters())
    last = len(grads.weights) - 1
    for i, (w, b) in enumerate(zip(grads.weights, grads.biases)):
        assert _rel(params[f"w{i}"].grad, w) <= 1e-8
        if i < last:
            assert _rel(params[f"b{i}"].grad, b) <= 1e-8
    # the loss reads the network's gradient only: the output bias has none
    assert params[f"b{last}"].grad is None and not np.asarray(grads.biases[last]).any()
    assert solve.iterations["backward"][0] <= 1


def _stateful_models(pkg, epochs, stateful=True):
    """The JAX test's stateful RVPINN (tests/test_vpinn.py) built with
    either package: unit square n=6, P1, Gram PCG at tol 1e-14."""
    is_port = pkg is pt
    kw = {"device": "cpu"} if is_port else {}
    mesh = pkg.MeshTri(pkg.unit_square(n=6), **kw)
    V = pkg.Basis(mesh, pkg.ElementTri(1, 2))
    solve = V.gram_solver(_stiffness, method="pcg", tol=1e-14)
    net = pkg.FeedForwardNeuralNetwork(2, 1, 1, 8, boundary_condition_modifier=_bc, seed=3, **kw)

    def step(net):
        r = V.reduce(V.integrate_linear_form(_residual, net.gradient))
        loss = (r.T @ solve(r))[0, 0]
        return loss, loss, loss

    def step_stateful(net, x_prev):
        r = V.reduce(V.integrate_linear_form(_residual, net.gradient))
        x = solve(r, x_prev)
        loss = (r.T @ x)[0, 0]
        return (loss, loss, loss), (x.detach() if is_port else jax.lax.stop_gradient(x))

    n_inner = int(V._basis_parameters["inner_dofs"].shape[0])
    if not stateful:
        return pkg.Model(net, step, epochs=epochs, progress_bar=False), solve
    x00 = torch.zeros((n_inner, 1), dtype=torch.float64) if is_port else jnp.zeros((n_inner, 1))
    return (
        pkg.Model(net, step_stateful, epochs=epochs, progress_bar=False, training_state0=x00),
        solve,
    )


@pytest.fixture(scope="module")
def jax_history():
    m, _ = _stateful_models(fem, 10)
    m.train()
    return m.get_training_history()[0]


@pytest.mark.parametrize("loop", ["train", "train_compiled"])
def test_stateful_model_matches_jax_and_the_cold_start(jax_history, loop):
    warm, solve = _stateful_models(pt, 10)
    cold, cold_solve = _stateful_models(pt, 10, stateful=False)
    for m in (warm, cold):
        m.train() if loop == "train" else m.train_compiled(5)
    hist = warm.get_training_history()[0]
    assert len(hist) == 10
    np.testing.assert_allclose(hist, jax_history, rtol=1e-8, atol=0)
    np.testing.assert_allclose(hist, cold.get_training_history()[0], rtol=1e-8, atol=0)
    # the state carried the iterate: the last solve's answer, which only
    # the warm model's solver started from
    assert len(solve.iterations["forward"]) == len(cold_solve.iterations["forward"]) == 10
    assert warm._training_state.shape == (25, 1) and bool(warm._training_state.any())
    assert cold._training_state is None


@pytest.mark.parametrize("loop", ["train", "train_compiled"])
def test_non_finite_epoch_resets_the_state(loop):
    """State counts epochs; epoch 2 of every run from the start state is
    non-finite, so the state the steps see is 0, 1, 2, 0, 1, 2, ... in both
    loops (the JAX loops reset to ``training_state0`` the same way)."""
    seen = []

    def step(net, state):
        seen.append(int(state))
        loss = (net(torch.ones(1, 2, dtype=torch.float64)) ** 2).sum()
        loss = loss + (math.inf if int(state) == 2 else 0.0)
        return (loss, loss, loss), state + 1

    net = pt.FeedForwardNeuralNetwork(2, 1, 1, 4, seed=0, device="cpu")
    m = pt.Model(net, step, epochs=7, progress_bar=False,
                 training_state0=torch.zeros((), dtype=torch.int64))
    m.train() if loop == "train" else m.train_compiled(3)
    assert seen == [0, 1, 2, 0, 1, 2, 0]
    assert int(m._training_state) == 1
