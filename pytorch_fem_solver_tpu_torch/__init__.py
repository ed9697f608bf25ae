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
from .basis import (
    AbstractBasis,
    Basis,
    BoundaryEdgesBasis,
    BoundaryFacesBasis,
    FractureBasis,
    FractureNetworkBasis,
    InteriorEdgesBasis,
    InteriorEdgesFractureBasis,
    InteriorEdgesNetworkBasis,
    InteriorFacesBasis,
    PatchesBasis,
)
from .element import ElementLine, ElementTet, ElementTri, ElementTriSurface
from .mesh import (
    FractureNetworkMesh,
    FracturesTri,
    MeshesTri,
    MeshTet,
    MeshTri,
    Patches,
    box,
    build_fracture_network,
    dorfler_mark,
    fichera_corner,
    rectangle,
    refine_adaptive,
    refine_adaptive_tet,
    refine_network_adaptive,
    refine_uniform,
    refine_uniform_tet,
    triangulation_max_area,
    unit_cube,
    unit_square,
)
from .models import FeedForwardNeuralNetwork, Model
from .utils import benchmark_seven_fracture_geometry, build_benchmark_network

__all__ = [
    "config",
    "AbstractBasis",
    "Basis",
    "FractureBasis",
    "FractureNetworkBasis",
    "InteriorEdgesNetworkBasis",
    "BoundaryEdgesBasis",
    "BoundaryFacesBasis",
    "InteriorEdgesBasis",
    "InteriorEdgesFractureBasis",
    "InteriorFacesBasis",
    "PatchesBasis",
    "ElementLine",
    "ElementTet",
    "ElementTri",
    "ElementTriSurface",
    "FractureNetworkMesh",
    "FracturesTri",
    "MeshesTri",
    "MeshTet",
    "MeshTri",
    "Patches",
    "box",
    "build_fracture_network",
    "dorfler_mark",
    "fichera_corner",
    "rectangle",
    "refine_adaptive",
    "refine_adaptive_tet",
    "refine_network_adaptive",
    "refine_uniform",
    "refine_uniform_tet",
    "triangulation_max_area",
    "unit_cube",
    "unit_square",
    "FeedForwardNeuralNetwork",
    "Model",
    "benchmark_seven_fracture_geometry",
    "build_benchmark_network",
]

__version__ = "0.1.0"
