"""Gaussian quadrature rules on the reference triangle, tetrahedron, segment.

Static host-side tables (NumPy float64). The convention matches the reference
library (reference torch_fem/element/element_tri.py:77-130 and
element_line.py:21-43): weights are *normalized* so they sum to one and the
integral weight is ``reference_element_measure * weight * |det J|``.

Triangle rules are the classical symmetric (Dunavant) rules on the reference
triangle with vertices (0,0), (1,0), (0,1); tetrahedron rules are the
classical symmetric (Keast) rules on the reference tet with vertices
(0,0,0), (1,0,0), (0,1,0), (0,0,1) — a 3D extension beyond the 2D-only
reference; segment rules are Gauss-Legendre on [-1, 1]. Every rule's
polynomial exactness is asserted against analytic monomial integrals in
``tests/test_element.py``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "triangle_rule",
    "tetrahedron_rule",
    "line_rule",
    "TRI_RULE_ORDERS",
    "TET_RULE_ORDERS",
    "LINE_RULE_ORDERS",
]


def _tri_rules() -> dict[int, tuple[np.ndarray, np.ndarray]]:
    rules: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # degree 1: centroid rule
    rules[1] = (
        np.array([[1.0 / 3.0, 1.0 / 3.0]]),
        np.array([1.0]),
    )

    # degree 2: 3-point symmetric rule
    rules[2] = (
        np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]]),
        np.array([1 / 3, 1 / 3, 1 / 3]),
    )

    # degree 3: 4-point rule (centroid + 3 symmetric points)
    rules[3] = (
        np.array([[1 / 3, 1 / 3], [0.6, 0.2], [0.2, 0.6], [0.2, 0.2]]),
        np.array([-9 / 16, 25 / 48, 25 / 48, 25 / 48]),
    )

    # degree 4: 6-point Dunavant rule
    a1, a2 = 0.816847572980459, 0.091576213509771
    b1, b2 = 0.108103018168070, 0.445948490915965
    w1, w2 = 0.109951743655322, 0.223381589678011
    rules[4] = (
        np.array(
            [[a1, a2], [a2, a1], [a2, a2], [b1, b2], [b2, b1], [b2, b2]]
        ),
        np.array([w1, w1, w1, w2, w2, w2]),
    )

    # degree 5: 7-point Dunavant rule (extension beyond the reference's max
    # order 4; useful for P2 mass matrices and error functionals)
    c = 1.0 / 3.0
    g1 = (6.0 - np.sqrt(15.0)) / 21.0
    g2 = (6.0 + np.sqrt(15.0)) / 21.0
    w0 = 9.0 / 40.0
    wg1 = (155.0 - np.sqrt(15.0)) / 1200.0
    wg2 = (155.0 + np.sqrt(15.0)) / 1200.0
    rules[5] = (
        np.array(
            [
                [c, c],
                [g1, g1],
                [1 - 2 * g1, g1],
                [g1, 1 - 2 * g1],
                [g2, g2],
                [1 - 2 * g2, g2],
                [g2, 1 - 2 * g2],
            ]
        ),
        np.array([w0, wg1, wg1, wg1, wg2, wg2, wg2]),
    )

    return rules


def _perm_aaab(a: float) -> np.ndarray:
    """The 4 barycentric permutations (a,a,a,b), b = 1-3a, as (x,y,z) nodes.

    Barycentric (l1,l2,l3,l4) maps to reference coords (l2,l3,l4).
    """
    b = 1.0 - 3.0 * a
    bary = np.array(
        [
            [b, a, a, a],
            [a, b, a, a],
            [a, a, b, a],
            [a, a, a, b],
        ]
    )
    return bary[:, 1:]


def _perm_aabb(a: float) -> np.ndarray:
    """The 6 barycentric permutations (a,a,b,b), b = 1/2-a, as (x,y,z) nodes."""
    b = 0.5 - a
    bary = np.array(
        [
            [a, a, b, b],
            [a, b, a, b],
            [a, b, b, a],
            [b, a, a, b],
            [b, a, b, a],
            [b, b, a, a],
        ]
    )
    return bary[:, 1:]


def _tet_rules() -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """Symmetric Keast rules; weights normalized to sum to 1 (= x6 the
    conventional tables, whose weights sum to the reference volume 1/6)."""
    rules: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # degree 1: centroid rule
    rules[1] = (np.array([[0.25, 0.25, 0.25]]), np.array([1.0]))

    # degree 2: 4-point symmetric rule
    a = (5.0 - np.sqrt(5.0)) / 20.0
    rules[2] = (_perm_aaab(a), np.full(4, 0.25))

    # degree 3: 5-point rule (centroid + 4), negative centroid weight
    nodes = np.concatenate([np.array([[0.25, 0.25, 0.25]]), _perm_aaab(1.0 / 6.0)])
    weights = np.concatenate([np.array([-0.8]), np.full(4, 0.45)])
    rules[3] = (nodes, weights)

    # degree 4: 11-point Keast rule
    nodes = np.concatenate(
        [
            np.array([[0.25, 0.25, 0.25]]),
            _perm_aaab(1.0 / 14.0),
            _perm_aabb(0.3994035761667992),
        ]
    )
    weights = 6.0 * np.concatenate(
        [
            np.array([-74.0 / 5625.0]),
            np.full(4, 343.0 / 45000.0),
            np.full(6, 56.0 / 2250.0),
        ]
    )
    rules[4] = (nodes, weights)

    # degree 5: 14-point rule (two aaab orbits + one aabb orbit; weights
    # already sum to 1 in this table's convention)
    nodes = np.concatenate(
        [
            _perm_aaab(0.3108859192633006),
            _perm_aaab(0.0927352503108912),
            _perm_aabb(0.0455037041256497),
        ]
    )
    weights = np.concatenate(
        [
            np.full(4, 0.1126879257180162),
            np.full(4, 0.0734930431163619),
            np.full(6, 0.0425460207770812),
        ]
    )
    rules[5] = (nodes, weights)

    return rules


def _line_rules() -> dict[int, tuple[np.ndarray, np.ndarray]]:
    rules: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # 1-point (midpoint) rule, exact for degree 1
    rules[1] = (np.array([[0.0]]), np.array([1.0]))

    # 2-point Gauss-Legendre, exact for degree 3 (the reference labels this
    # "integration_order 2", element_line.py:23-29 — we keep that labelling)
    s = 1.0 / np.sqrt(3.0)
    rules[2] = (np.array([[-s], [s]]), np.array([0.5, 0.5]))

    # 3-point Gauss-Legendre, exact for degree 5
    t = np.sqrt(3.0 / 5.0)
    rules[3] = (np.array([[0.0], [-t], [t]]), np.array([8 / 18, 5 / 18, 5 / 18]))

    # 4-point Gauss-Legendre (extension)
    p1 = np.sqrt(3.0 / 7.0 - 2.0 / 7.0 * np.sqrt(6.0 / 5.0))
    p2 = np.sqrt(3.0 / 7.0 + 2.0 / 7.0 * np.sqrt(6.0 / 5.0))
    w1 = (18.0 + np.sqrt(30.0)) / 36.0 / 2.0
    w2 = (18.0 - np.sqrt(30.0)) / 36.0 / 2.0
    rules[4] = (
        np.array([[-p2], [-p1], [p1], [p2]]),
        np.array([w2, w1, w1, w2]),
    )

    return rules


_TRI_RULES = _tri_rules()
_TET_RULES = _tet_rules()
_LINE_RULES = _line_rules()
TRI_RULE_ORDERS = tuple(sorted(_TRI_RULES))
TET_RULE_ORDERS = tuple(sorted(_TET_RULES))
LINE_RULE_ORDERS = tuple(sorted(_LINE_RULES))


def triangle_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (nodes (n_q, 2), normalized weights (n_q,)) on the ref triangle."""
    if order not in _TRI_RULES:
        raise NotImplementedError(
            f"Triangle integration order {order} not implemented "
            f"(available: {TRI_RULE_ORDERS})"
        )
    nodes, weights = _TRI_RULES[order]
    return nodes.copy(), weights.copy()


def tetrahedron_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (nodes (n_q, 3), normalized weights (n_q,)) on the ref tet."""
    if order not in _TET_RULES:
        raise NotImplementedError(
            f"Tetrahedron integration order {order} not implemented "
            f"(available: {TET_RULE_ORDERS})"
        )
    nodes, weights = _TET_RULES[order]
    return nodes.copy(), weights.copy()


def line_rule(order: int) -> tuple[np.ndarray, np.ndarray]:
    """Return (nodes (n_q, 1), normalized weights (n_q,)) on [-1, 1]."""
    if order not in _LINE_RULES:
        raise NotImplementedError(
            f"Line integration order {order} not implemented "
            f"(available: {LINE_RULE_ORDERS})"
        )
    nodes, weights = _LINE_RULES[order]
    return nodes.copy(), weights.copy()
