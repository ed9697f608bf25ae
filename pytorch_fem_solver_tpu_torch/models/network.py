"""Neural trial functions for VPINNs.

Counterpart of ``pytorch_fem_solver_tpu/models/network.py`` as an
``nn.Module``. The parameters carry the JAX package's names and layout:
``w{i}`` of shape (fan_in, fan_out) and ``b{i}`` of shape (fan_out,), and a
layer computes ``h @ w + b`` as the JAX network does, so
``dict(net.named_parameters())`` is the JAX ``parameters()`` dict and a
seeded network holds the JAX network's numbers exactly.

Derivatives:

* ``gradient``: one ``torch.autograd.grad`` on a ``requires_grad`` copy of
  the points, with ``create_graph`` whenever autograd is recording, so a
  loss built on it differentiates again with respect to the parameters (the
  VPINN double backward). Under ``torch.no_grad()`` it still returns the
  gradient, without keeping a graph.
* ``laplacian``: one more ``autograd.grad`` per input coordinate of the
  gradient (reverse over reverse).
"""

from __future__ import annotations

import copy
import math
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import config


def _as_tensor(value) -> torch.Tensor:
    """A tensor as it is; anything else (NumPy, a JAX array) as a writable
    CPU copy."""
    return value if isinstance(value, torch.Tensor) else torch.from_numpy(np.array(value))


def identity_bc(x: torch.Tensor) -> torch.Tensor:
    """Default boundary-condition modifier: multiply by one (no constraint)."""
    return torch.ones_like(x[..., :1])


class FeedForwardNeuralNetwork(nn.Module):
    """MLP with optional strong-Dirichlet boundary modifier.

    Output = mlp(x) * boundary_condition_modifier(x), so homogeneous
    Dirichlet conditions hold exactly by construction. ``device`` defaults
    to the card (``config.resolve_device``), ``dtype`` to
    ``config.default_dtype()``.
    """

    def __init__(
        self,
        input_dimension: int,
        output_dimension: int,
        nb_hidden_layers: int,
        neurons_per_layers: int,
        activation_function: Callable = torch.tanh,
        use_xavier_initialization: bool = False,
        boundary_condition_modifier: Optional[Callable] = None,
        seed: int = 0,
        final_layer_scale: float = 1.0,
        *,
        device=None,
        dtype: torch.dtype | None = None,
    ):
        super().__init__()
        self.input_dimension = int(input_dimension)
        self.output_dimension = int(output_dimension)
        self.nb_hidden_layers = int(nb_hidden_layers)
        self.neurons_per_layers = int(neurons_per_layers)
        self.activation_function = activation_function
        self.boundary_condition_modifier = (
            boundary_condition_modifier
            if boundary_condition_modifier is not None
            else identity_bc
        )

        dims = (
            [self.input_dimension]
            + [self.neurons_per_layers] * (self.nb_hidden_layers + 1)
            + [self.output_dimension]
        )
        self.n_layers = len(dims) - 1
        device = config.resolve_device(device)
        dtype = dtype or config.default_dtype()
        # the JAX package's draw order: per layer the (fan_in, fan_out)
        # weight, then the bias, from one NumPy generator
        rng = np.random.default_rng(seed)
        for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
            if use_xavier_initialization:
                bound = math.sqrt(6.0 / (fan_in + fan_out))
            else:
                bound = 1.0 / math.sqrt(fan_in)
            w = torch.tensor(
                rng.uniform(-bound, bound, size=(fan_in, fan_out)), dtype=dtype, device=device
            )
            b_bound = 1.0 / math.sqrt(fan_in)
            b = torch.tensor(
                rng.uniform(-b_bound, b_bound, size=(fan_out,)), dtype=dtype, device=device
            )
            if i == self.n_layers - 1 and final_layer_scale != 1.0:
                # shrinking the output layer starts training near u = 0,
                # which stabilizes variational losses
                w = w * final_layer_scale
                b = b * final_layer_scale
            self.register_parameter(f"w{i}", nn.Parameter(w))
            self.register_parameter(f"b{i}", nn.Parameter(b))

    @property
    def weights(self) -> tuple:
        return tuple(getattr(self, f"w{i}") for i in range(self.n_layers))

    @property
    def biases(self) -> tuple:
        return tuple(getattr(self, f"b{i}") for i in range(self.n_layers))

    # -- forward and derivatives -------------------------------------------

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Forward pass at points x (..., input_dimension) -> (..., out)."""
        weights, biases = self.weights, self.biases
        h = x
        for w, b in zip(weights[:-1], biases[:-1]):
            h = self.activation_function(h @ w + b)
        h = h @ weights[-1] + biases[-1]
        return h * self.boundary_condition_modifier(x)

    def gradient(self, inputs: torch.Tensor) -> torch.Tensor:
        """d(output)/d(inputs), shape (..., input_dimension).

        Keeps the graph (differentiable again) whenever autograd records.
        """
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = inputs if inputs.requires_grad else inputs.detach().requires_grad_(True)
            out = self(x)
            (grad,) = torch.autograd.grad(
                out, x, torch.ones_like(out), create_graph=create_graph
            )
        return grad

    def laplacian(self, inputs: torch.Tensor) -> torch.Tensor:
        """Sum of second derivatives w.r.t. each input coordinate (..., 1)."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = inputs.detach().requires_grad_(True)
            grad = self.gradient(x)
            lap = torch.zeros_like(inputs[..., :1])
            for i in range(self.input_dimension):
                (hess_col,) = torch.autograd.grad(
                    grad[..., i].sum(), x, create_graph=create_graph,
                    retain_graph=True,
                )
                lap = lap + hess_col[..., i : i + 1]
        return lap

    # -- parameter utilities ----------------------------------------------

    def with_parameters(self, params: dict) -> "FeedForwardNeuralNetwork":
        """A copy with the parameters ``{"w0": ..., "b0": ...}`` (the JAX
        names and layout, as tensors or NumPy arrays); this network is left
        as it is. Raises ``ValueError`` on a shape that does not match."""
        obj = copy.deepcopy(self)
        with torch.no_grad():
            for name, p in obj.named_parameters():
                value = _as_tensor(params[name])
                if tuple(value.shape) != tuple(p.shape):
                    raise ValueError(f"{name}: shape {tuple(value.shape)} != {tuple(p.shape)}")
                p.copy_(value)
        return obj
