"""Reference elements and quadrature."""

from .abstract_element import AbstractElement
from .element_line import ElementLine
from .element_tet import ElementTet
from .element_tri import ElementTri, ElementTriSurface

__all__ = ["AbstractElement", "ElementLine", "ElementTet", "ElementTri", "ElementTriSurface"]
