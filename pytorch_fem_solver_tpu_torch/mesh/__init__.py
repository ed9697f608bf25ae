"""Mesh layer: host-built, statically shaped triangle meshes of tensors."""

from .dfn import build_fracture_network
from .fracture_network import FractureNetworkMesh, fit_affine_maps
from .mesh_tri import MeshTri
from .pslg import triangulate_pslg
from .quality import triangle_min_angles

__all__ = [
    "FractureNetworkMesh",
    "MeshTri",
    "build_fracture_network",
    "fit_affine_maps",
    "triangle_min_angles",
    "triangulate_pslg",
]
