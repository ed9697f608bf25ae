"""Reference elements and quadrature."""

from .abstract_element import AbstractElement
from .element_line import ElementLine
from .element_tet import ElementTet
from .element_tri import ElementTri, ElementTriSurface
from .quadrature import line_rule, tetrahedron_rule, triangle_rule

__all__ = [
    "AbstractElement",
    "ElementLine",
    "ElementTet",
    "ElementTri",
    "ElementTriSurface",
    "line_rule",
    "tetrahedron_rule",
    "triangle_rule",
]
