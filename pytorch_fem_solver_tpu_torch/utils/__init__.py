"""Utilities: profiling, VTK export, benchmark geometry.

``watchdog``, ``plotting`` and ``html3d`` are imported by module path, as
in the JAX package.
"""

from .profiling import StepTimer, trace
from .seven_fractures import (
    benchmark_seven_fracture_geometry,
    build_benchmark_network,
)
from .vtk import write_vtk

__all__ = [
    "StepTimer",
    "write_vtk",
    "trace",
    "benchmark_seven_fracture_geometry",
    "build_benchmark_network",
]
