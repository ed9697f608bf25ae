"""Basis layer: P1-P3 assembly on triangle and tetrahedral meshes, fracture
networks and batched patches, and the edge and face bases of the jump and
flux terms."""

from .abstract_basis import AbstractBasis
from .basis import Basis
from .faces_basis import BoundaryFacesBasis, InteriorFacesBasis
from .fracture_basis import FractureBasis, build_global_triangulation
from .fracture_network_basis import FractureNetworkBasis, InteriorEdgesNetworkBasis
from .interior_edges_basis import BoundaryEdgesBasis, InteriorEdgesBasis
from .interior_edges_fracture_basis import InteriorEdgesFractureBasis
from .patches_basis import PatchesBasis

__all__ = [
    "AbstractBasis",
    "Basis",
    "BoundaryEdgesBasis",
    "BoundaryFacesBasis",
    "FractureBasis",
    "FractureNetworkBasis",
    "InteriorEdgesBasis",
    "InteriorEdgesFractureBasis",
    "InteriorEdgesNetworkBasis",
    "InteriorFacesBasis",
    "PatchesBasis",
    "build_global_triangulation",
]
