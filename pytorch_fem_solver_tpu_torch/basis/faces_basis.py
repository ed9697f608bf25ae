"""Triangle-quadrature bases over the faces of a 3D tetrahedral mesh.

Counterpart of ``pytorch_fem_solver_tpu/basis/faces_basis.py``: the edge
bases one dimension up. ``InteriorFacesBasis`` carries the quadrature of
jump and flux-jump functionals (the two-sided traces of
``Basis.interpolate``); ``BoundaryFacesBasis`` assembles Neumann/Robin
surface terms and boundary flux functionals (the one-sided traces). Both
inherit the whole facet implementation through ``facet_group``; only the
element differs: a face is a 2D chart embedded in R^3, so it takes an
:class:`ElementTriSurface` (Gram-determinant measure, pseudo-inverse map).
"""

from __future__ import annotations

from ..element.element_tri import ElementTriSurface
from .interior_edges_basis import InteriorEdgesBasis


class InteriorFacesBasis(InteriorEdgesBasis):
    """P1-P3 basis on interior faces (triangle charts embedded in the 3D
    mesh). ``mesh["interior_faces", "normals"]`` holds the unit normals
    oriented from the first adjacent cell toward the second, the
    orientation jump estimators contract against."""

    facet_group = "interior_faces"

    def __init__(self, mesh, element):
        if not isinstance(element, ElementTriSurface):
            raise TypeError(
                "face bases integrate over 2D charts embedded in R^3 and "
                "need the Gram-determinant measure: pass "
                "ElementTriSurface(1, q), not "
                f"{type(element).__name__}"
            )
        super().__init__(mesh, element)


class BoundaryFacesBasis(InteriorFacesBasis):
    """Quadrature basis over the boundary faces of a 3D mesh: linear forms
    over it assemble Neumann/Robin surface terms into the global DOF
    vector, and ``integrate_functional`` gives surface functionals (the
    total outward flux, for one)."""

    facet_group = "boundary_faces"
