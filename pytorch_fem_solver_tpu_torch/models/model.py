"""Training harness for VPINN models.

Counterpart of ``pytorch_fem_solver_tpu/models/model.py``: a user-supplied
``training_step(net) -> (loss, validation, accuracy)``, an epoch loop with
a ``torch.optim`` optimizer (Adam at 1e-3 by default), early stopping, the
best-parameter snapshot, a non-finite guard, histories and ``.npz``
checkpoints that include the optimizer state.

``train()`` reads the three scalars back once per epoch, as the JAX loop
does. ``train_compiled(block_size)`` runs ``block_size`` epochs with no host
read and reads the block's scalars back once: the best snapshot, the
best loss and the non-finite count live on the device, and a non-finite
epoch holds the parameters and the optimizer state through ``torch.where``
on flat copies (a few launches per epoch, no host sync).

On a CUDA network the optimizer is built ``capturable`` where its class
takes that option, so its step counter lives on the card: the hold then
covers the whole optimizer state, and ``train()`` and ``train_compiled()``
run the same arithmetic.

Learning-rate schedulers follow the JAX package's ``optax.chain(optimizer,
scheduler)``: each epoch the scheduler maps the epoch's loss to a
multiplier of the update, computed before the update it multiplies.
``"reduce_on_plateau"`` is :class:`ReduceOnPlateau`, optax's rule written
out by hand (``torch.optim.lr_scheduler.ReduceLROnPlateau`` follows a
different one); a scheduler already built (an instance with an ``init``,
such as a ``ReduceOnPlateau(...)``) is taken as it is, as the JAX package
takes a ``GradientTransformation``; any other scheduler is called as
``learning_rate_scheduler(**scheduler_kwargs)`` and must return such a
callable. The optimizer's update is linear in its learning rate (Adam's
and SGD's are), so the multiplier is applied as ``lr = lr0 * scale``, with
``lr0`` the built optimizer's learning rate (its default where
``optimizer_kwargs`` names none) and
``lr`` a 0-dim tensor on the parameters' device that is updated in place:
no host read per epoch. A scheduler's ``state`` (a dict of tensors, as
:class:`ReduceOnPlateau` keeps it) is held with the optimizer state on a
non-finite epoch, reset with it in ``train()`` and written to checkpoints.

The stateful protocol of the JAX package: with ``training_state0`` given,
``training_step(net, state) -> ((loss, validation, accuracy), new_state)``
and the state (a tensor, or a tuple, list or dict of them) rides the epoch
loop, e.g. the previous epoch's Gram iterate that warm-starts the next
epoch's PCG. The state must not change the loss's gradient. A non-finite
epoch resets it to ``training_state0`` in both loops.
"""

from __future__ import annotations

import copy
import inspect
import math
import time
from collections import defaultdict
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch.utils import _pytree as pytree


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat(flat: torch.Tensor, like) -> list:
    """Views of ``flat`` shaped like the tensors of ``like``."""
    parts = flat.split([t.numel() for t in like])
    return [p.view_as(t) for p, t in zip(parts, like)]


def _grouped(tensors) -> list:
    """The tensors split into lists of one dtype and device each."""
    groups = defaultdict(list)
    for t in tensors:
        groups[(t.dtype, t.device)].append(t)
    return list(groups.values())


class _FlatCopies:
    """Persistent flat buffers for a fixed list of tensors, a pair per dtype
    and device, with views shaped like the tensors: a copy in or out is one
    ``_foreach_copy_`` and no view is made per epoch."""

    def __init__(self, tensors):
        self.ids = [id(t) for t in tensors]
        self.groups = []
        for group in _grouped(tensors):
            n = sum(t.numel() for t in group)
            saved, scratch = group[0].new_empty(n), group[0].new_empty(n)
            self.groups.append(
                (group, saved, _unflat(saved, group), scratch, _unflat(scratch, group))
            )

    def save(self) -> None:
        for group, _, saved_views, _, _ in self.groups:
            torch._foreach_copy_(saved_views, group)

    def keep_where(self, cond: torch.Tensor) -> None:
        """Each tensor keeps its value where ``cond``, else takes back its
        saved one."""
        for group, saved, _, scratch, scratch_views in self.groups:
            torch._foreach_copy_(scratch_views, group)
            torch.where(cond, scratch, saved, out=scratch)
            torch._foreach_copy_(group, scratch_views)


def _detached(value) -> torch.Tensor:
    """A state leaf as a tensor outside the autograd graph."""
    return value.detach() if torch.is_tensor(value) else torch.as_tensor(value)


class ReduceOnPlateau:
    """``optax.contrib.reduce_on_plateau`` (optax 0.2.6) by hand.

    ``scale = scheduler(loss)`` folds the loss into a running mean over
    ``accumulation_size`` epochs; when the mean is complete it counts as an
    improvement if ``mean < (1 - rtol) * best - atol``. ``patience``
    epochs without one multiply the scale by ``factor`` (never below
    ``min_scale``) and start ``cooldown`` epochs in which the plateau count
    stays 0. The state lives in 0-dim tensors (``init`` places them), each
    updated in place with ``torch.where``, so a call reads nothing back to
    the host.
    """

    def __init__(
        self,
        factor: float = 0.1,
        patience: int = 10,
        rtol: float = 1e-4,
        atol: float = 0.0,
        cooldown: int = 0,
        accumulation_size: int = 1,
        min_scale: float = 0.0,
    ):
        if factor <= 0.0 or factor >= 1.0:
            raise ValueError(f"Factor must be in the range (0, 1), got factor = {factor}.")
        if rtol < 0.0 or atol < 0.0:
            raise ValueError(
                f"Both rtol and atol must be non-negative, got rtol = {rtol} and atol = {atol}."
            )
        if rtol == 0.0 and atol == 0.0:
            raise ValueError(
                f"At least one of rtol or atol must be positive, got rtol = {rtol} and atol = {atol}."
            )
        if rtol > 1.0:
            raise ValueError(f"rtol must be less than or equal to 1.0, got rtol = {rtol}.")
        self.factor, self.patience, self.rtol, self.atol = factor, patience, rtol, atol
        self.cooldown, self.accumulation_size, self.min_scale = cooldown, accumulation_size, min_scale
        self.state: dict = {}

    def init(self, like: torch.Tensor) -> None:
        """(Re)set the state on ``like``'s device, floats in its dtype."""
        if not self.state:
            self.state = {
                "scale": like.new_empty(()),
                "best_value": like.new_empty(()),
                "plateau_count": like.new_empty((), dtype=torch.int32),
                "cooldown_count": like.new_empty((), dtype=torch.int32),
                "count": like.new_empty((), dtype=torch.int32),
                "avg_value": like.new_empty(()),
            }
        with torch.no_grad():
            for name, value in (("scale", 1.0), ("best_value", math.inf), ("plateau_count", 0),
                                ("cooldown_count", 0), ("count", 0), ("avg_value", 0.0)):
                self.state[name].fill_(value)

    @torch.no_grad()
    def __call__(self, value: torch.Tensor) -> torch.Tensor:
        s = self.state
        count = s["count"]
        new_count = count + 1
        avg = (count * s["avg_value"] + value.to(s["avg_value"].dtype)) / new_count
        full = new_count == self.accumulation_size
        # the plateau logic, applied where the mean is complete
        improved = avg < (1 - self.rtol) * s["best_value"] - self.atol
        best = torch.where(improved, avg, s["best_value"])
        plateau = torch.where(improved, 0, s["plateau_count"] + 1).to(torch.int32)
        hit = plateau == self.patience
        scale = s["scale"]
        reduced = torch.maximum(
            torch.where(hit, scale * self.factor, scale), scale.new_tensor(self.min_scale)
        )
        cooling = s["cooldown_count"] > 0
        new_plateau = torch.where(cooling | hit, 0, plateau).to(torch.int32)
        new_scale = torch.where(cooling, scale, reduced)
        new_cooldown = torch.where(
            cooling, s["cooldown_count"] - 1, torch.where(hit, self.cooldown, 0)
        ).to(torch.int32)
        s["plateau_count"].copy_(torch.where(full, new_plateau, s["plateau_count"]))
        s["best_value"].copy_(torch.where(full, best, s["best_value"]))
        s["scale"].copy_(torch.where(full, new_scale, scale))
        s["cooldown_count"].copy_(torch.where(full, new_cooldown, s["cooldown_count"]))
        s["count"].copy_(torch.where(full, 0, new_count))
        s["avg_value"].copy_(torch.where(full, 0.0, avg))
        return s["scale"]


def _is_built_scheduler(scheduler) -> bool:
    """A scheduler object already built (JAX's ``GradientTransformation``
    branch): an instance, not a class or factory, that carries an
    ``init`` for its state, as ``ReduceOnPlateau`` does."""
    return not isinstance(scheduler, type) and callable(getattr(scheduler, "init", None))


def _architecture_signature(net) -> str:
    """The layer names and shapes, e.g. ``w0:(2, 15);b0:(15,);...``."""
    return ";".join(f"{n}:{tuple(p.shape)}" for n, p in net.named_parameters())


class Model:
    """Trains a neural-network trial function against a variational loss."""

    def __init__(
        self,
        neural_network,
        training_step: Callable,
        epochs: int = 5000,
        optimizer: Any = torch.optim.Adam,
        optimizer_kwargs: Optional[dict] = None,
        learning_rate_scheduler: Optional[Any] = None,
        scheduler_kwargs: Optional[dict] = None,
        use_early_stopping: bool = False,
        early_stopping_patience: int = 10,
        min_delta: float = 1e-12,
        progress_bar: bool = True,
        training_state0: Any = None,
    ):
        self._neural_network = neural_network
        self._stateful = training_state0 is not None
        self._training_state0 = (
            pytree.tree_map(_detached, training_state0) if self._stateful else None
        )
        self._training_state = self._training_state0
        self._training_step = training_step
        self._epochs = int(epochs)

        kwargs = dict(optimizer_kwargs or {"lr": 1e-3})
        # accept the JAX package's spelling
        if "learning_rate" in kwargs:
            kwargs["lr"] = kwargs.pop("learning_rate")
        self._optimizer_class = optimizer
        self._optimizer_kwargs = kwargs

        self._scheduler = None
        self._lr = None
        self._optimizer = self._make_optimizer()
        if learning_rate_scheduler is not None:
            if learning_rate_scheduler == "reduce_on_plateau":
                self._scheduler = ReduceOnPlateau(**(scheduler_kwargs or {}))
            elif _is_built_scheduler(learning_rate_scheduler):
                self._scheduler = learning_rate_scheduler
            else:
                self._scheduler = learning_rate_scheduler(**(scheduler_kwargs or {}))
            param0 = next(iter(neural_network.parameters()))
            # the optimizer's own default where optimizer_kwargs gives none
            self._lr0 = float(self._optimizer.param_groups[0]["lr"])
            self._lr = torch.tensor(self._lr0, dtype=torch.float64, device=param0.device)
            self._reset_scheduler()
            self._optimizer = self._make_optimizer()

        self._use_early_stopping = use_early_stopping
        self._early_stopping_patience = int(early_stopping_patience)
        self._min_delta = float(min_delta)
        self._progress_bar = progress_bar

        self._loss_history: list[float] = []
        self._validation_loss_history: list[float] = []
        self._accuracy_history: list[float] = []
        self._epoch_times: list[float] = []

        self._best_loss = float("inf")
        self.optimal_parameters = self._snapshot()
        self.early_stopping_counter = 0
        self._diverged_steps = 0

    # -- internals ---------------------------------------------------------

    def _make_optimizer(self):
        params = list(self._neural_network.parameters())
        kwargs = dict(self._optimizer_kwargs)
        if (
            params
            and params[0].is_cuda
            and "capturable" in inspect.signature(self._optimizer_class).parameters
        ):
            kwargs.setdefault("capturable", True)
        if self._lr is not None:
            kwargs["lr"] = self._lr
        return self._optimizer_class(params, **kwargs)

    def _reset_scheduler(self) -> None:
        """The scheduler's initial state and learning rate (optax's
        ``init``)."""
        init = getattr(self._scheduler, "init", None)
        if init is not None:
            init(next(iter(self._neural_network.parameters())).detach())
        self._lr.fill_(self._lr0)

    def _schedule(self, loss: torch.Tensor) -> None:
        """This epoch's multiplier from its loss, into the learning rate
        of the step that follows."""
        if self._scheduler is not None:
            scale = torch.as_tensor(self._scheduler(loss), dtype=self._lr.dtype, device=self._lr.device)
            self._lr.copy_(scale * self._lr0)

    def _load_optimizer_state(self, state_dict) -> None:
        self._optimizer.load_state_dict(state_dict)
        if self._lr is not None:  # the loaded groups hold copies of the tensor
            for group in self._optimizer.param_groups:
                group["lr"] = self._lr

    def _scheduler_state(self) -> dict:
        return getattr(self._scheduler, "state", None) or {}

    def _snapshot(self) -> dict:
        return {
            n: p.detach().clone() for n, p in self._neural_network.named_parameters()
        }

    def _load_parameters(self, params: dict) -> None:
        with torch.no_grad():
            for n, p in self._neural_network.named_parameters():
                p.copy_(params[n])

    def _epoch(self, state=None):
        """One forward + backward; returns ((loss, validation, accuracy) as
        detached 0-d tensors, the detached new state). The optimizer step is
        left to the caller."""
        self._optimizer.zero_grad(set_to_none=True)
        if self._stateful:
            (loss, validation, accuracy), state = self._training_step(
                self._neural_network, state
            )
            state = pytree.tree_map(_detached, state)
        else:
            loss, validation, accuracy = self._training_step(self._neural_network)
        loss = loss.reshape(())
        loss.backward()
        return (
            loss.detach(),
            torch.as_tensor(validation).detach().reshape(()).to(loss),
            torch.as_tensor(accuracy).detach().reshape(()).to(loss),
        ), state

    def _held_tensors(self) -> list:
        """The parameters and the optimizer's state tensors."""
        params = list(self._neural_network.parameters())
        held = list(params)
        for p in params:
            held += [v for v in self._optimizer.state.get(p, {}).values() if torch.is_tensor(v)]
        return held + list(self._scheduler_state().values())

    # -- public API --------------------------------------------------------

    def train(self):
        """Run the epoch loop; returns the trained network."""
        iterator = range(self._epochs)
        bar = None
        if self._progress_bar:
            try:
                import tqdm

                bar = tqdm.tqdm(iterator, desc="Training Progress")
                iterator = bar
            except ImportError:
                pass

        state = self._training_state
        for _ in iterator:
            t0 = time.perf_counter()
            scalars, state_new = self._epoch(state)
            scalars = torch.stack(scalars)
            loss_value, validation_value, accuracy_value = scalars.tolist()
            self._epoch_times.append(time.perf_counter() - t0)
            # history first, aligned with _epoch_times: the guard and the
            # early stop below must not drop the epoch they evaluated
            self._loss_history.append(loss_value)
            self._validation_loss_history.append(validation_value)
            self._accuracy_history.append(accuracy_value)

            # a non-finite loss would poison the parameters and the optimizer
            # state: skip the update and fall back to the best snapshot
            if not math.isfinite(loss_value):
                self._load_parameters(self.optimal_parameters)
                if self._scheduler is not None:
                    self._reset_scheduler()
                self._optimizer = self._make_optimizer()
                # a non-finite epoch may have poisoned the warm-start state
                state = self._training_state0
                self._diverged_steps += 1
                if self._diverged_steps > 10:
                    break
                continue

            # snapshot the parameters that ACHIEVED loss_value (the
            # pre-update ones) before stepping
            if self._use_early_stopping:
                if loss_value < self._best_loss - self._min_delta:
                    self._best_loss = loss_value
                    self.early_stopping_counter = 0
                    self.optimal_parameters = self._snapshot()
                else:
                    self.early_stopping_counter += 1
                    if self.early_stopping_counter >= self._early_stopping_patience:
                        break
            elif loss_value < self._best_loss:
                self._best_loss = loss_value
                self.optimal_parameters = self._snapshot()

            self._schedule(scalars[0])
            self._optimizer.step()
            state = state_new

            if bar is not None:
                bar.set_postfix(
                    {
                        "Loss": f"{loss_value:.8f}",
                        "Validation loss": f"{validation_value:.8f}",
                        "Accuracy": f"{accuracy_value:.8f}",
                    }
                )
        self._training_state = state
        return self._neural_network

    def train_compiled(self, block_size: int = 100):
        """Epoch blocks with one host read each: ``block_size`` epochs run
        back to back on the device, and their losses and metrics are read
        back once per block.

        Per-epoch math is that of :meth:`train`; where the host used to step
        in mid-epoch the semantics are the JAX package's:

        * the best snapshot (the pre-update parameters of the lowest finite
          loss, under the ``min_delta`` margin with early stopping) is
          tracked on the device;
        * a non-finite epoch holds the parameters and the optimizer state
          (the eager loop resets to the snapshot); more than 10 of them
          stop training at the next block edge;
        * early stopping replays the patience rule on the block's losses;
          after a stop in mid-block the block is re-run from its saved
          start state for exactly ``stop_epoch + 1`` epochs, so nothing past
          the stopping point reaches the parameters or the snapshot, and
          the live network is then the best snapshot;
        * with ``training_state0``, a non-finite epoch resets the state to
          it (``torch.where`` on the device), as the eager loop does.
        """
        block_size = max(1, int(block_size))
        use_es = self._use_early_stopping
        margin = self._min_delta if use_es else 0.0
        net = self._neural_network
        params = list(net.parameters())
        names = [n for n, _ in net.named_parameters()]

        n_params = sum(p.numel() for p in params)
        best_loss = torch.tensor(self._best_loss, dtype=params[0].dtype, device=params[0].device)
        carry = [
            best_loss,
            _flat(params).detach(),
            torch.zeros_like(best_loss, dtype=torch.int64),
            self._training_state,
        ]
        state0 = self._training_state0
        copies = None

        def run_block(length, carry):
            nonlocal copies
            best_loss, best_flat, n_bad, state = carry
            rows = []
            for _ in range(length):
                (loss, validation, accuracy), state_new = self._epoch(state)
                finite = torch.isfinite(loss)
                if self._stateful:
                    state = pytree.tree_map(
                        lambda new, first: torch.where(finite, new, first), state_new, state0
                    )
                improved = finite & (loss < best_loss - margin)
                held = self._held_tensors()
                if copies is None or copies.ids != [id(t) for t in held]:
                    copies = _FlatCopies(held)
                with torch.no_grad():
                    copies.save()  # the parameters come first: pre-step values
                    best_flat = torch.where(improved, copies.groups[0][1][:n_params], best_flat)
                    best_loss = torch.where(improved, loss, best_loss)
                    n_bad = n_bad + ~finite
                    self._schedule(loss)
                    self._optimizer.step()
                    # a non-finite epoch holds the parameters and the
                    # optimizer state; state the step created (the first
                    # step's) falls back to zeros, the fresh state
                    copies.keep_where(finite)
                    saved_ids = set(copies.ids)
                    for t in self._held_tensors():
                        if id(t) not in saved_ids:
                            t.copy_(torch.where(finite, t, torch.zeros_like(t)))
                rows.append(torch.stack([loss, validation, accuracy]))
            return torch.stack(rows), [best_loss, best_flat, n_bad, state]

        done = 0
        stopped = False
        while done < self._epochs and not stopped:
            length = min(block_size, self._epochs - done)
            if use_es:
                # the block's start state, re-entered after a mid-block stop
                start = (
                    pytree.tree_map(lambda t: t if t is None else t.clone(), carry),
                    [p.detach().clone() for p in params],
                    copy.deepcopy(self._optimizer.state_dict()),
                    {k: v.clone() for k, v in self._scheduler_state().items()},
                )
            t0 = time.perf_counter()
            rows, carry = run_block(length, carry)
            rows = rows.cpu().numpy()  # the block's one host read
            block_dt = (time.perf_counter() - t0) / length
            done += length

            # replay the eager per-epoch bookkeeping on the block's scalars
            stop_epoch = None
            for e in range(length):
                lv = float(rows[e, 0])
                self._epoch_times.append(block_dt)
                self._loss_history.append(lv)
                self._validation_loss_history.append(float(rows[e, 1]))
                self._accuracy_history.append(float(rows[e, 2]))
                if not math.isfinite(lv):
                    continue
                if use_es:
                    if lv < self._best_loss - self._min_delta:
                        self._best_loss = lv
                        self.early_stopping_counter = 0
                    else:
                        self.early_stopping_counter += 1
                        if self.early_stopping_counter >= self._early_stopping_patience:
                            stopped = True
                            stop_epoch = e
                            break
                elif lv < self._best_loss:
                    self._best_loss = lv
            if stop_epoch is not None and stop_epoch + 1 < length:
                # the block ran past the stopping point: re-run it from its
                # start state for exactly the epochs the eager loop ran
                carry0, params0, opt0, sched0 = start
                with torch.no_grad():
                    torch._foreach_copy_(params, params0)
                    for k, v in sched0.items():
                        self._scheduler_state()[k].copy_(v)
                self._load_optimizer_state(opt0)
                _, carry = run_block(stop_epoch + 1, carry0)
            if int(carry[2]) > 10:
                stopped = True

        self._training_state = carry[3]
        best = _unflat(carry[1], params)
        self.optimal_parameters = {n: b.clone() for n, b in zip(names, best)}
        if stopped:
            self._load_parameters(self.optimal_parameters)
        return self._neural_network

    @property
    def neural_network(self):
        return self._neural_network

    def get_training_history(self):
        return (
            self._loss_history,
            self._validation_loss_history,
            self._accuracy_history,
        )

    def load_optimal_parameters(self):
        """Restore the best-seen parameters into the live network."""
        self._load_parameters(self.optimal_parameters)
        return self._neural_network

    # -- checkpointing -----------------------------------------------------

    def save_checkpoint(self, path: str):
        """Write parameters, optimizer state and histories to ``path``
        (.npz), with the architecture signature checked on load. The
        optimizer state (Adam's moments and step) and the scheduler's state
        make a resumed run continue the interrupted trajectory."""
        net = self._neural_network
        arrays = {
            f"param_{n}": p.detach().cpu().numpy() for n, p in net.named_parameters()
        }
        for idx, state in self._optimizer.state_dict()["state"].items():
            for key, value in state.items():
                arrays[f"opt_{idx}_{key}"] = (
                    value.detach().cpu().numpy() if torch.is_tensor(value) else np.asarray(value)
                )
        for key, value in self._scheduler_state().items():
            arrays[f"sched_{key}"] = value.detach().cpu().numpy()
        arrays["architecture"] = np.array(_architecture_signature(net))
        arrays["loss_history"] = np.asarray(self._loss_history)
        arrays["validation_loss_history"] = np.asarray(self._validation_loss_history)
        arrays["accuracy_history"] = np.asarray(self._accuracy_history)
        np.savez(path, **arrays)

    def load_checkpoint(self, path: str):
        """Restore parameters, optimizer state and histories.

        Raises ``ValueError`` if the checkpoint's layer names and shapes do
        not match the live network.
        """
        data = np.load(path)
        live = _architecture_signature(self._neural_network)
        saved = str(data["architecture"])
        if saved != live:
            raise ValueError(
                f"checkpoint {path!r} was written for a different network "
                f"architecture:\n  checkpoint: {saved}\n  live:       {live}"
            )
        self._load_parameters(
            {n: torch.as_tensor(data[f"param_{n}"]) for n, _ in self._neural_network.named_parameters()}
        )
        state: dict = {}
        for key in data.files:
            if key.startswith("opt_"):
                _, idx, name = key.split("_", 2)
                state.setdefault(int(idx), {})[name] = torch.as_tensor(data[key])
        if state:
            opt_state = self._optimizer.state_dict()
            opt_state["state"] = state
            self._load_optimizer_state(opt_state)
        with torch.no_grad():
            for key, value in self._scheduler_state().items():
                if f"sched_{key}" in data.files:
                    value.copy_(torch.as_tensor(data[f"sched_{key}"]))
        if self._scheduler is not None and "scale" in self._scheduler_state():
            self._lr.copy_(self._scheduler_state()["scale"] * self._lr0)
        self._loss_history = [float(v) for v in data["loss_history"]]
        self._validation_loss_history = [float(v) for v in data["validation_loss_history"]]
        self._accuracy_history = [float(v) for v in data["accuracy_history"]]
        return self._neural_network

    def plot_training_history(self, plot_names: Optional[dict] = None):
        """Semilogy plot of the loss, validation and accuracy histories;
        returns the axis. Needs matplotlib, imported here only."""
        import matplotlib.pyplot as plt

        if plot_names is None:
            plot_names = {
                "loss": "Training loss",
                "validation": "Validation loss",
                "accuracy": "Accuracy",
                "title": "Training history",
            }

        _, axis = plt.subplots()
        axis.semilogy(self._loss_history, linestyle="-", label=plot_names["loss"])
        axis.semilogy(
            self._validation_loss_history, linestyle="--", label=plot_names["validation"]
        )
        axis.semilogy(self._accuracy_history, linestyle=":", label=plot_names["accuracy"])
        axis.set_xlabel("# Epochs")
        axis.set_ylabel("Loss")
        axis.set_title(plot_names["title"])
        axis.legend()
        return axis
