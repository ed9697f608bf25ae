"""Mesh layer: host-built, statically shaped triangle and tetrahedral
meshes of tensors."""

from .dfn import build_fracture_network
from .fracture_network import FractureNetworkMesh, fit_affine_maps
from .fractures_tri import FracturesTri
from .generation import (
    box,
    fichera_corner,
    rectangle,
    refine_uniform,
    refine_uniform_tet,
    triangulation_max_area,
    unit_cube,
    unit_square,
)
from .mesh_tet import MeshTet
from .mesh_tri import MeshTri
from .meshes_tri import MeshesTri
from .patches import Patches
from .pslg import triangulate_pslg
from .quality import triangle_min_angles
from .refinement import (
    dorfler_mark,
    refine_adaptive,
    refine_adaptive_tet,
    refine_network_adaptive,
)

__all__ = [
    "FractureNetworkMesh",
    "FracturesTri",
    "MeshTet",
    "MeshTri",
    "MeshesTri",
    "Patches",
    "box",
    "build_fracture_network",
    "dorfler_mark",
    "fichera_corner",
    "fit_affine_maps",
    "rectangle",
    "refine_adaptive",
    "refine_adaptive_tet",
    "refine_network_adaptive",
    "refine_uniform",
    "refine_uniform_tet",
    "triangle_min_angles",
    "triangulate_pslg",
    "triangulation_max_area",
    "unit_cube",
    "unit_square",
]
