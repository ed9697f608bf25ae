"""Mesh layer: host-built, statically shaped triangle meshes of tensors."""

from .dfn import build_fracture_network
from .fracture_network import FractureNetworkMesh, fit_affine_maps
from .fractures_tri import FracturesTri
from .generation import rectangle, refine_uniform, triangulation_max_area, unit_square
from .mesh_tri import MeshTri
from .meshes_tri import MeshesTri
from .patches import Patches
from .pslg import triangulate_pslg
from .quality import triangle_min_angles
from .refinement import dorfler_mark, refine_adaptive, refine_network_adaptive

__all__ = [
    "FractureNetworkMesh",
    "FracturesTri",
    "MeshTri",
    "MeshesTri",
    "Patches",
    "build_fracture_network",
    "dorfler_mark",
    "fit_affine_maps",
    "rectangle",
    "refine_adaptive",
    "refine_network_adaptive",
    "refine_uniform",
    "triangle_min_angles",
    "triangulate_pslg",
    "triangulation_max_area",
    "unit_square",
]
