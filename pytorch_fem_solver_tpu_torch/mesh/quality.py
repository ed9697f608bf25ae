"""Mesh quality metrics: triangle min-angles and quality reports.

The reference delegates quality meshing to the ``triangle`` library's "q"
flag (min-angle >= 20 degrees by default, e.g.
reference examples/example_fractures_fem.py:44-46). Here quality is a
measured, asserted property: ``triangle_min_angles`` is the metric,
``quality_report`` the summary, and ``triangulate_pslg(min_angle=...)``
the enforcement knob (Lloyd-style smoothing of free points).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "triangle_min_angles",
    "quality_report",
    "tet_min_dihedral_angles",
    "tet_quality_report",
]


def triangle_min_angles(vertices, triangles) -> np.ndarray:
    """Per-triangle minimum interior angle in degrees, shape (T,)."""
    p = np.asarray(vertices, dtype=np.float64)[np.asarray(triangles)]
    mins = None
    for i in range(3):
        a = p[:, (i + 1) % 3] - p[:, i]
        b = p[:, (i + 2) % 3] - p[:, i]
        na = np.linalg.norm(a, axis=-1)
        nb = np.linalg.norm(b, axis=-1)
        cos = (a * b).sum(-1) / np.where(na * nb > 0, na * nb, 1.0)
        ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        mins = ang if mins is None else np.minimum(mins, ang)
    return mins


def quality_report(vertices, triangles) -> dict:
    """Quality summary: min / percentile min-angles and area statistics."""
    angles = triangle_min_angles(vertices, triangles)
    p = np.asarray(vertices, dtype=np.float64)[np.asarray(triangles)]
    areas = 0.5 * np.abs(
        (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1])
        - (p[:, 1, 1] - p[:, 0, 1]) * (p[:, 2, 0] - p[:, 0, 0])
    )
    return {
        "min_angle": float(angles.min()),
        "p1_angle": float(np.percentile(angles, 1)),
        "median_angle": float(np.median(angles)),
        "min_area": float(areas.min()),
        "max_area": float(areas.max()),
        "total_area": float(areas.sum()),
        "n_triangles": int(len(angles)),
    }


def tet_min_dihedral_angles(vertices, tetrahedra) -> np.ndarray:
    """Per-tet minimum dihedral angle in degrees, shape (T,).

    The dihedral along edge (a, b) is the angle between the two faces
    sharing it, computed from their (outward-agnostic) normals. Six edges
    per tet; the regular tet's dihedral is ~70.53 deg, the structured Kuhn
    subdivision's minimum is 45 deg. 3D counterpart of
    :func:`triangle_min_angles`.
    """
    p = np.asarray(vertices, dtype=np.float64)[np.asarray(tetrahedra)]
    # edge (i, j) with opposite vertices (k, l): faces (i, j, k), (i, j, l)
    edges = [
        (0, 1, 2, 3), (1, 2, 0, 3), (0, 2, 1, 3),
        (0, 3, 1, 2), (1, 3, 0, 2), (2, 3, 0, 1),
    ]
    mins = None
    for i, j, k, l in edges:
        e = p[:, j] - p[:, i]
        n1 = np.cross(e, p[:, k] - p[:, i])
        n2 = np.cross(e, p[:, l] - p[:, i])
        denom = np.linalg.norm(n1, axis=-1) * np.linalg.norm(n2, axis=-1)
        cos = (n1 * n2).sum(-1) / np.where(denom > 0, denom, 1.0)
        # n1, n2 both point "away" from the edge into their faces; the
        # dihedral is pi minus the angle between them... both normals are
        # e x (vertex - i), so the interior dihedral IS their angle
        ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
        mins = ang if mins is None else np.minimum(mins, ang)
    return mins


def tet_quality_report(vertices, tetrahedra) -> dict:
    """Quality summary for a tet mesh: dihedral angles, radius-edge ratio
    and volume statistics. ``radius_edge`` is circumradius / shortest edge
    (>= sqrt(6)/4 ~ 0.612 for the regular tet; slivers blow it up)."""
    vertices = np.asarray(vertices, dtype=np.float64)
    tetrahedra = np.asarray(tetrahedra)
    angles = tet_min_dihedral_angles(vertices, tetrahedra)
    p = vertices[tetrahedra]
    d = (p[:, 1:] - p[:, [0]]).transpose(0, 2, 1)
    vols = np.abs(np.linalg.det(d)) / 6.0

    # circumradius via the closed form R = |alpha| / (12 V) with
    # alpha = |a|^2 (b x c) + |b|^2 (c x a) + |c|^2 (a x b); degenerate
    # (zero-volume) slivers report R = inf rather than raising — those are
    # exactly the tets the radius-edge metric exists to flag
    a = p[:, 1] - p[:, 0]
    b = p[:, 2] - p[:, 0]
    c = p[:, 3] - p[:, 0]
    alpha = (
        (a * a).sum(-1, keepdims=True) * np.cross(b, c)
        + (b * b).sum(-1, keepdims=True) * np.cross(c, a)
        + (c * c).sum(-1, keepdims=True) * np.cross(a, b)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        circum = np.where(
            vols > 0, np.linalg.norm(alpha, axis=-1) / (12.0 * vols), np.inf
        )
    e = p[:, [[0, 1], [1, 2], [0, 2], [0, 3], [1, 3], [2, 3]]]
    lmin = np.linalg.norm(e[:, :, 1] - e[:, :, 0], axis=-1).min(1)
    radius_edge = circum / np.where(lmin > 0, lmin, 1.0)

    return {
        "min_dihedral": float(angles.min()),
        "p1_dihedral": float(np.percentile(angles, 1)),
        "median_dihedral": float(np.median(angles)),
        "max_radius_edge": float(radius_edge.max()),
        "min_volume": float(vols.min()),
        "max_volume": float(vols.max()),
        "total_volume": float(vols.sum()),
        "n_tetrahedra": int(len(angles)),
    }
