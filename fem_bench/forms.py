"""The coefficient and load a request of the scalar P1 problem
(``problems/poisson_p1.py``) hands to the program, written as a user writes
forms for the port.

``kappa(x) * grad v . grad w`` and ``f(x) * v``, with the two fields of
``fields.py`` evaluated at ``V.integration_points`` from small device
tensors of their parameters, and f(x) the configuration's load (a module
of ``loads/``) plus the traffic's load field. ``Forms.set`` overwrites those tensors in
place before each request (one host-to-device copy per field that changes),
so the program's solver, built once at set-up, reads the new sample. The
forms read only ``v``, ``v_grad`` and ``integration_points``, which a chunk
view of the basis has too.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fields import FieldSpec


class DeviceField:
    """One field's parameters on the device and its evaluation there."""

    def __init__(self, spec: FieldSpec, device, dtype):
        self.spec = spec
        self.dtype = dtype
        self.params = torch.zeros(spec.modes if not spec.constant else 0, 4, device=device,
                                  dtype=dtype)
        self.scale = math.sqrt(2.0 / spec.modes)

    def set(self, params: np.ndarray) -> None:
        if not self.spec.constant:
            self.params.copy_(torch.from_numpy(params.astype(_np_dtype(self.dtype))))

    def at(self, points: torch.Tensor) -> torch.Tensor:
        """The field at ``points`` (..., 1, 3) as (..., 1, 1)."""
        s = self.spec
        if s.constant:
            value = math.exp(s.mean) if s.transform == "exp" else s.mean
            return torch.full(points.shape[:-1] + (1,), value, dtype=points.dtype,
                              device=points.device)
        phase = points @ self.params[:, :3].T + self.params[:, 3]
        g = phase.cos_().sum(-1, keepdim=True)
        z = s.mean + (s.sigma * self.scale) * g
        return z.exp_() if s.transform == "exp" else z


def _np_dtype(dtype: torch.dtype):
    return {torch.float32: np.float32, torch.float64: np.float64}[dtype]


class Forms:
    """The bilinear and linear forms of -div(kappa grad u) = f."""

    def __init__(self, coefficient: FieldSpec, load: FieldSpec, base_load, device, dtype):
        self.kappa = DeviceField(coefficient, device, dtype)
        self.f = DeviceField(load, device, dtype)
        self.base_load = base_load  # points (..., 3) -> (..., 1)

    def set(self, kappa_params: np.ndarray | None, f_params: np.ndarray | None) -> None:
        if kappa_params is not None:
            self.kappa.set(kappa_params)
        if f_params is not None:
            self.f.set(f_params)

    def a(self, V):
        return self.kappa.at(V.integration_points) * (V.v_grad @ V.v_grad.mT)

    def l(self, V):  # noqa: E743 - the linear form's usual name
        x = V.integration_points
        f = self.base_load(x)
        s = self.f.spec
        if not (s.constant and s.transform == "affine" and s.mean == 0.0):
            f = f + self.f.at(x)
        return f * V.v
