"""PyTorch/CUDA port of ``pytorch_fem_solver_tpu`` (the JAX package).

Same module paths and public names as the JAX package, written in PyTorch:
plain functions on tensors, NamedTuples where JAX had them, an explicit
``device=`` and no jit. Host-side structure building stays NumPy and moves
to the device once. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``. Hand-written CUDA kernels live in ``csrc/`` and are built
at first use (``ops.cuda_build``).

This package imports neither ``jax`` nor ``pytorch_fem_solver_tpu``.
"""

from . import config
from .basis import AbstractBasis, Basis, FractureNetworkBasis
from .element import ElementTri
from .mesh import FractureNetworkMesh, MeshTri, build_fracture_network
from .utils import benchmark_seven_fracture_geometry, build_benchmark_network

__all__ = [
    "config",
    "AbstractBasis",
    "Basis",
    "FractureNetworkBasis",
    "ElementTri",
    "FractureNetworkMesh",
    "MeshTri",
    "build_fracture_network",
    "benchmark_seven_fracture_geometry",
    "build_benchmark_network",
]

__version__ = "0.1.0"
