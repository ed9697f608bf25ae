"""Basis layer: P1 assembly on triangle meshes and fracture networks."""

from .abstract_basis import AbstractBasis
from .basis import Basis
from .fracture_basis import FractureBasis, build_global_triangulation
from .fracture_network_basis import FractureNetworkBasis

__all__ = [
    "AbstractBasis",
    "Basis",
    "FractureBasis",
    "FractureNetworkBasis",
    "build_global_triangulation",
]
