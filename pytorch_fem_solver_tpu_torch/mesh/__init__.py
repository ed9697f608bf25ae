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
from .quality import (
    quality_report,
    tet_min_dihedral_angles,
    tet_quality_report,
    triangle_min_angles,
)
from .refinement import (
    dorfler_mark,
    refine_adaptive,
    refine_adaptive_tet,
    refine_network_adaptive,
)

# the JAX package's list; the port's own helpers imported above
# (build_fracture_network, fit_affine_maps, refine_network_adaptive,
# triangulation_max_area) are importable by name and stay out of it
__all__ = [
    "MeshTet",
    "MeshTri",
    "MeshesTri",
    "FracturesTri",
    "FractureNetworkMesh",
    "triangulate_pslg",
    "triangle_min_angles",
    "quality_report",
    "tet_min_dihedral_angles",
    "tet_quality_report",
    "Patches",
    "box",
    "fichera_corner",
    "rectangle",
    "unit_cube",
    "dorfler_mark",
    "refine_adaptive",
    "refine_adaptive_tet",
    "refine_uniform",
    "refine_uniform_tet",
    "unit_square",
]
