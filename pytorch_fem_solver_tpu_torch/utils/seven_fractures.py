"""The seven-fracture DFN benchmark geometry.

Counterpart of ``pytorch_fem_solver_tpu/utils/seven_fractures.py``, limited
to the deterministic benchmark network. The raw-dataset loader
(``load_seven_fractures_raw``) reads files this port does not ship and is
not ported.
"""

from __future__ import annotations

import numpy as np

from ..mesh.dfn import build_fracture_network
from ..mesh.fracture_network import FractureNetworkMesh

__all__ = ["benchmark_seven_fracture_geometry", "build_benchmark_network"]


def benchmark_seven_fracture_geometry():
    """The framework's deterministic 7-fracture benchmark network.

    Seven axis-aligned rectangles forming a densely connected network (every
    vertical fracture crosses the horizontal ones and its perpendicular
    peers), producing 21+ traces with triple points. Geometry is fixed so
    benchmark numbers are comparable across runs.
    """
    return [
        np.asarray(r, dtype=np.float64)
        for r in [
            [[0, 0, 0], [4, 0, 0], [4, 4, 0], [0, 4, 0]],  # z = 0
            [[1, 0, -2], [1, 4, -2], [1, 4, 2], [1, 0, 2]],  # x = 1
            [[3, 0, -2], [3, 4, -2], [3, 4, 2], [3, 0, 2]],  # x = 3
            [[0, 1, -2], [4, 1, -2], [4, 1, 2], [0, 1, 2]],  # y = 1
            [[0, 3, -2], [4, 3, -2], [4, 3, 2], [0, 3, 2]],  # y = 3
            [[0.5, 0.5, -1], [3.5, 0.5, -1], [3.5, 3.5, -1], [0.5, 3.5, -1]],
            [[0.5, 0.5, 1], [3.5, 0.5, 1], [3.5, 3.5, 1], [0.5, 3.5, 1]],
        ]
    ]


def build_benchmark_network(h: float, *, device=None, dtype=None) -> FractureNetworkMesh:
    """Conforming mesh of the benchmark network at edge length h."""
    return build_fracture_network(
        benchmark_seven_fracture_geometry(), h=h, device=device, dtype=dtype
    )
