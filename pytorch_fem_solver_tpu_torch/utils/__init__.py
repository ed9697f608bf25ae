"""Utilities: benchmark geometry."""

from .seven_fractures import (
    benchmark_seven_fracture_geometry,
    build_benchmark_network,
)

__all__ = ["benchmark_seven_fracture_geometry", "build_benchmark_network"]
