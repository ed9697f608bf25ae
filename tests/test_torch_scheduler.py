"""PyTorch port, learning-rate schedulers and the training plot of ``Model``.

The port's ``ReduceOnPlateau`` is held against the installed optax
``contrib.reduce_on_plateau`` on a hand-written loss sequence that
improves, plateaus, cools down and reaches ``min_scale`` (every state field
equal after every call, with ``accumulation_size`` 1 and 3). Then the
2D RVPINN (``make_rvpinn(n=8, width=8, depth=2)``, the repo-root
``bench_vpinn.py`` step) trains 15 epochs under the plateau scheduler, and
its loss, relative-loss and H1 histories are held against the JAX
``Model`` with ``learning_rate_scheduler="reduce_on_plateau"`` on the same
seeded network to 1e-10 relative, in float64 on the CPU; a user-given
transformation (optax's ``scale``, a constant multiplier in the port) the
same. A ``ReduceOnPlateau`` built by the caller is taken as it is (the
JAX package's ``GradientTransformation`` branch), and without an ``lr`` in
``optimizer_kwargs`` the scale multiplies the optimizer's default.
``train_compiled`` equals ``train`` under the scheduler, the
scheduler's state rides the checkpoint, and the plot's three lines hold the
histories.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench_vpinn import make_rvpinn
from pytorch_fem_solver_tpu_torch.models.model import ReduceOnPlateau

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

N, WIDTH, DEPTH, EPOCHS = 8, 8, 2, 15
PLATEAU = {"factor": 0.5, "patience": 2, "rtol": 1e-2, "cooldown": 1}
FIELDS = ("scale", "best_value", "plateau_count", "cooldown_count", "count", "avg_value")
# improvement, a plateau, a cut, cooldown, the min_scale floor, a
# non-finite value, and an improvement inside the atol margin (not one)
LOSSES = [10, 9, 8, 8, 8, 8, 7.9999, 7, 7, 7, 7, 7, 7, 7, 7, 6, 6, 6, 6, 6, 6, 6, 6, 6, 6, 5,
          math.nan, 5, 5, 5, 5, 5, 4.9995, 4.999, 4] + [4] * 24


def _optax_states(losses, **kw):
    tx = optax.contrib.reduce_on_plateau(**kw)
    state = tx.init(jnp.zeros(3))
    rows = []
    for value in losses:
        _, state = tx.update(jnp.ones(3), state, value=jnp.asarray(value))
        rows.append([float(getattr(state, f)) for f in FIELDS])
    return np.array(rows)


@pytest.mark.parametrize("accumulation_size", [1, 3])
def test_plateau_state_sequence_matches_optax(accumulation_size):
    kw = dict(factor=0.5, patience=2, rtol=1e-4, atol=1e-3, cooldown=2,
              accumulation_size=accumulation_size, min_scale=0.2)
    ref = _optax_states(LOSSES, **kw)
    sched = ReduceOnPlateau(**kw)
    sched.init(torch.zeros(3, dtype=torch.float64))
    rows = []
    for value in LOSSES:
        scale = sched(torch.tensor(value, dtype=torch.float64))
        assert scale is sched.state["scale"] and scale.dim() == 0
        rows.append([float(sched.state[f]) for f in FIELDS])
    np.testing.assert_array_equal(np.array(rows), ref)
    scales = ref[:, 0]
    # the sequence reaches every branch of the rule
    assert scales.min() == 0.2 and len(set(scales)) == 4  # 1, 0.5, 0.25, the floor
    assert (ref[:, 3] > 0).any()  # cooldown


def test_plateau_arguments_raise_as_optax():
    for bad in ({"factor": 1.0}, {"rtol": -1.0}, {"rtol": 0.0, "atol": 0.0}, {"rtol": 2.0}):
        with pytest.raises(ValueError) as ours:
            ReduceOnPlateau(**bad)
        with pytest.raises(ValueError) as ref:
            optax.contrib.reduce_on_plateau(**bad)
        assert str(ours.value) == str(ref.value)


def _bc(inputs):
    x, y = inputs[..., 0:1], inputs[..., 1:2]
    return x * (x - 1) * y * (y - 1)


def _jax_step(n=N, width=WIDTH, depth=DEPTH, seed=0):
    """The repo-root bench_vpinn.py training step on the JAX package."""
    V = fem.Basis(fem.MeshTri(fem.unit_square(n=n)), fem.ElementTri(1, 4))
    net = fem.FeedForwardNeuralNetwork(2, 1, depth, width, boundary_condition_modifier=_bc, seed=seed)
    gram_inv = jnp.linalg.inv(V.reduce(V.integrate_bilinear_form(
        lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad))))
    sin, cos, pi = jnp.sin, jnp.cos, math.pi

    def exact(p):
        x, y = p[..., 0:1], p[..., 1:2]
        return (sin(pi * x) * sin(pi * y), pi * cos(pi * x) * sin(pi * y),
                pi * sin(pi * x) * cos(pi * y))

    exact_norm = jnp.sqrt(jnp.sum(V.integrate_functional(
        lambda b: sum(e**2 for e in exact(b.integration_points)))))

    def residual(b, gradient):
        p = b.integration_points
        return 2 * pi**2 * exact(p)[0] * b.v - b.v_grad @ jnp.matrix_transpose(gradient(p))

    def h1(b, net, gradient):
        p = b.integration_points
        u, ux, uy = exact(p)
        g = gradient(p)
        return (u - net(p)) ** 2 + (ux - g[..., 0:1]) ** 2 + (uy - g[..., 1:2]) ** 2

    def training_step(net):
        r = V.reduce(V.integrate_linear_form(residual, net.gradient))
        loss = (r.T @ (gram_inv @ r))[0, 0]
        h1_err = jnp.sqrt(jnp.sum(V.integrate_functional(h1, net, net.gradient)))
        return loss, jnp.sqrt(loss) / exact_norm**2, h1_err / exact_norm

    return net, training_step


def _port_model(epochs=EPOCHS, **kw):
    r = make_rvpinn(N, WIDTH, DEPTH, epochs=1, device="cpu")
    return pt.Model(r.network, r.training_step, epochs=epochs, progress_bar=False, **kw)


def _held(ours, ref, rtol=1e-10):
    for a, b in zip(ours.get_training_history(), ref.get_training_history()):
        assert len(a) == len(b) == EPOCHS
        np.testing.assert_allclose(a, b, rtol=rtol, atol=0)


@pytest.fixture(scope="module")
def jax_plateau():
    net, step = _jax_step()
    model = fem.Model(net, step, epochs=EPOCHS, progress_bar=False,
                      learning_rate_scheduler="reduce_on_plateau", scheduler_kwargs=PLATEAU)
    model.train()
    return model


def test_rvpinn_with_plateau_matches_jax_model(jax_plateau):
    ours = _port_model(learning_rate_scheduler="reduce_on_plateau", scheduler_kwargs=PLATEAU)
    ours.train()
    _held(ours, jax_plateau)
    # the scale was cut during the run, as in optax's state
    scale = float(ours._scheduler.state["scale"])
    assert scale < 1.0 and scale == float(jax_plateau._opt_state[1].scale)
    assert float(ours._optimizer.param_groups[0]["lr"]) == 1e-3 * scale


def test_built_plateau_is_taken_as_it_is(jax_plateau):
    # JAX's GradientTransformation branch: an object already built is not
    # called with scheduler_kwargs
    sched = ReduceOnPlateau(**PLATEAU)
    ours = _port_model(learning_rate_scheduler=sched)
    assert ours._scheduler is sched
    ours.train()
    _held(ours, jax_plateau)
    assert float(sched.state["scale"]) == float(jax_plateau._opt_state[1].scale)


def test_scheduler_lr_is_the_optimizers_default():
    # optimizer_kwargs without an lr: the scale multiplies Adam's own 1e-3
    kw = dict(learning_rate_scheduler="reduce_on_plateau", scheduler_kwargs=PLATEAU, epochs=5)
    implicit = _port_model(optimizer_kwargs={"betas": (0.8, 0.99)}, **kw)
    explicit = _port_model(optimizer_kwargs={"lr": 1e-3, "betas": (0.8, 0.99)}, **kw)
    assert implicit._lr0 == 1e-3
    assert implicit._optimizer.param_groups[0]["lr"] is implicit._lr
    implicit.train()
    explicit.train()
    assert implicit.get_training_history() == explicit.get_training_history()


def test_user_transformation_matches_jax_model():
    net, step = _jax_step()
    ref = fem.Model(net, step, epochs=EPOCHS, progress_bar=False,
                    learning_rate_scheduler=optax.scale, scheduler_kwargs={"step_size": 0.5})
    ref.train()
    ours = _port_model(learning_rate_scheduler=lambda step_size: (lambda loss: step_size),
                       scheduler_kwargs={"step_size": 0.5})
    ours.train()
    _held(ours, ref)


def test_train_compiled_with_plateau_equals_train():
    kw = dict(learning_rate_scheduler="reduce_on_plateau", scheduler_kwargs=PLATEAU)
    eager, blocked = _port_model(**kw), _port_model(**kw)
    eager.train()
    blocked.train_compiled(block_size=4)
    _held(blocked, eager, rtol=1e-12)
    for name in FIELDS:
        assert torch.equal(eager._scheduler.state[name], blocked._scheduler.state[name])


def test_plateau_state_rides_the_checkpoint(tmp_path):
    kw = dict(learning_rate_scheduler="reduce_on_plateau", scheduler_kwargs=PLATEAU)
    straight = _port_model(epochs=12, **kw)
    straight.train()
    first = _port_model(epochs=8, **kw)
    first.train()
    assert float(first._scheduler.state["scale"]) < 1.0
    path = str(tmp_path / "plateau.npz")
    first.save_checkpoint(path)
    second = _port_model(epochs=4, **kw)
    second.load_checkpoint(path)
    for name in FIELDS:
        assert torch.equal(second._scheduler.state[name], first._scheduler.state[name])
    assert second._optimizer.param_groups[0]["lr"] is second._lr
    second.train()
    assert second.get_training_history()[0][-4:] == straight.get_training_history()[0][8:]


def test_plot_training_history_holds_the_histories():
    pytest.importorskip("matplotlib")
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    model = _port_model(epochs=3)
    model.train()
    axis = model.plot_training_history()
    lines = axis.get_lines()
    assert len(lines) == 3
    for line, hist in zip(lines, model.get_training_history()):
        np.testing.assert_array_equal(line.get_ydata(), hist)
    assert axis.get_title() == "Training history" and axis.get_yscale() == "log"
    plt.close(axis.figure)
