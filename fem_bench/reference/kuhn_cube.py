"""The cube's nodes are its vertices; Dirichlet where a coordinate is 0 or 1."""

from __future__ import annotations

import numpy as np

from .p1 import Glued


def glue(inp: dict) -> Glued:
    v = inp["vertices"]
    boundary = (np.abs(v) < 1e-12).any(1) | (np.abs(v - 1.0) < 1e-12).any(1)
    return Glued(v[inp["tetrahedra"]], inp["tetrahedra"], boundary, np.arange(len(v)))
