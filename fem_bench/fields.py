"""The random fields that make the coefficients and loads of the traffic.

One generator serves every mix: a stationary Gaussian field with a
squared-exponential covariance of length ``l``, drawn as M random Fourier
features,

    g(x) = sqrt(2 / M) * sum_m cos(w_m . x + phi_m),
    w_m ~ N(0, I / l^2),  phi_m ~ U(0, 2 pi),

which has unit variance. A field spec of a traffic file turns g into a
coefficient (``"transform": "exp"``: kappa = exp(mean + sigma g)) or a load
(``"affine"``: f = mean + sigma g); ``sigma`` 0 is the constant ``mean``
(``exp(mean)`` for ``"exp"``), and no features are drawn. ``l`` is
``corr_length_rel`` times the configuration's ``domain_edge``.

The parameters of request ``i`` of a run with seed ``s`` come from
``numpy.random.default_rng([s, stream, 0, i])`` alone, so the same
``(seed, i)`` gives the same field whatever ran before; a spec with
``per_request`` false draws once, from ``[s, stream, 1]``, and warm-up
requests draw from ``[s, stream, 2, j]``. This module imports no part of the
program: the program's forms and the reference read the same parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

#: one stream id per field role, so a coefficient and a load never share draws
STREAMS = {"coefficient": 11, "load": 23}


class FieldSpec(NamedTuple):
    """A field of a traffic file (see the module docstring)."""

    transform: str  # "exp" or "affine"
    mean: float
    sigma: float
    corr_length: float  # absolute, in the mesh's units
    modes: int
    per_request: bool

    @property
    def constant(self) -> bool:
        return self.sigma == 0.0


def field_spec(raw: dict, domain_edge: float) -> FieldSpec:
    """A ``FieldSpec`` from a traffic file's field entry, checked."""
    transform = raw["transform"]
    if transform not in ("exp", "affine"):
        raise ValueError(f"field transform must be 'exp' or 'affine', got {transform!r}")
    spec = FieldSpec(
        transform=transform,
        mean=float(raw.get("mean", 0.0)),
        sigma=float(raw.get("sigma", 0.0)),
        corr_length=float(raw.get("corr_length_rel", 1.0)) * float(domain_edge),
        modes=int(raw.get("modes", 32)),
        per_request=bool(raw.get("per_request", True)),
    )
    if spec.sigma < 0 or spec.corr_length <= 0 or spec.modes < 1:
        raise ValueError(f"bad field spec {raw!r}")
    return spec


def seed_words(seed: int) -> list[int]:
    """The run's seed as non-negative 32-bit words (any whole number)."""
    s = int(seed) % (1 << 128)
    return [(s >> (32 * k)) & 0xFFFFFFFF for k in range(4)]


def draw(spec: FieldSpec, role: str, seed: int, index: int | None, warmup: bool = False) -> np.ndarray:
    """The (modes, 4) float64 parameters ``[w_x, w_y, w_z, phi]`` of one
    field: request ``index`` of the window, warm-up request ``index`` with
    ``warmup``, or the run's one draw where ``index`` is None or the spec
    is not per request. A constant spec has no parameters (shape
    (0, 4))."""
    if spec.constant:
        return np.zeros((0, 4))
    if index is None or not spec.per_request:
        key = [1]
    elif warmup:
        key = [2, int(index)]
    else:
        key = [0, int(index)]
    rng = np.random.default_rng([*seed_words(seed), STREAMS[role], *key])
    w = rng.normal(0.0, 1.0 / spec.corr_length, size=(spec.modes, 3))
    phi = rng.uniform(0.0, 2.0 * np.pi, size=(spec.modes, 1))
    return np.concatenate([w, phi], axis=1)


def params(specs: dict, seed: int, index: int | None, warmup: bool = False) -> dict:
    """``draw`` for each role of ``specs`` (role -> ``FieldSpec``)."""
    return {role: draw(spec, role, seed, index, warmup=warmup) for role, spec in specs.items()}
