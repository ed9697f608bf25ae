"""Utilities: profiling, VTK export, benchmark geometry.

``watchdog``, ``plotting`` and ``html3d`` are imported by module path, as
in the JAX package.

Only ``profiling`` is imported with the package: ``ops`` records its spans
through it, and ``vtk`` (which reads the basis) and ``seven_fractures``
(the mesh) import modules that import ``ops``. Their names load on first
use (PEP 562), so ``ops`` can import ``utils.profiling`` without a cycle.
"""

import importlib

from .profiling import StepTimer, trace

#: the names loaded on first use, by module
_LAZY = {
    "write_vtk": ".vtk",
    "benchmark_seven_fracture_geometry": ".seven_fractures",
    "build_benchmark_network": ".seven_fractures",
}

__all__ = [
    "StepTimer",
    "write_vtk",
    "trace",
    "benchmark_seven_fracture_geometry",
    "build_benchmark_network",
]


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(_LAZY[name], __name__), name)
    globals()[name] = value
    return value
