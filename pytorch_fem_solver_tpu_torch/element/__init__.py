"""Reference elements and quadrature."""

from .abstract_element import AbstractElement
from .element_line import ElementLine
from .element_tri import ElementTri

__all__ = ["AbstractElement", "ElementLine", "ElementTri"]
