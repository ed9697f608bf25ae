"""General DFN construction: planar rectangles in 3D -> conforming network mesh.

Counterpart of ``pytorch_fem_solver_tpu/mesh/dfn.py`` (host NumPy, copied so
that the port imports nothing of the JAX package). It takes arbitrary planar
rectangles in 3D and produces a conforming :class:`FractureNetworkMesh`:

1. an orthonormal in-plane frame per rectangle (isometric 2D charts);
2. pairwise plane-plane intersections clipped to both rectangles -> 3D trace
   segments;
3. traces split at mutual 3D intersections (triple points), boundary edges
   split where traces end on them — so every fracture's PSLG is valid and
   every shared line is sampled identically from all sides;
4. per-fracture conforming Delaunay meshing (``triangulate_pslg``) with
   shared division counts along traces;
5. cross-fracture vertex dedup in :class:`FractureNetworkMesh` -> global
   DOFs with automatic trace continuity.

All host-side NumPy, runs once at setup; only the finished mesh moves to
``device``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import config
from .fracture_network import FractureNetworkMesh
from .pslg import triangulate_pslg

__all__ = ["build_fracture_network", "rectangle_fracture"]

_TOL = 1e-9


def rectangle_fracture(corners) -> np.ndarray:
    """Validate and return a (4, 3) planar rectangle (corners in order)."""
    c = np.asarray(corners, dtype=np.float64).reshape(4, 3)
    e1 = c[1] - c[0]
    e2 = c[3] - c[0]
    if abs(e1 @ e2) > 1e-9 * np.linalg.norm(e1) * np.linalg.norm(e2):
        raise ValueError("fracture corners must form a rectangle (ordered)")
    if np.linalg.norm((c[0] + e1 + e2) - c[2]) > 1e-9:
        raise ValueError("fracture corners must be ordered around the rectangle")
    return c


def _frame(corners):
    """Orthonormal chart: origin + unit axes; returns (origin, e1, e2, w, h)."""
    o = corners[0]
    d1 = corners[1] - corners[0]
    d2 = corners[3] - corners[0]
    w = np.linalg.norm(d1)
    h = np.linalg.norm(d2)
    return o, d1 / w, d2 / h, w, h


def _to2d(points, origin, e1, e2):
    rel = np.asarray(points) - origin
    return np.stack([rel @ e1, rel @ e2], axis=-1)


def _trace_segment(ci, cj):
    """3D intersection segment of two rectangles, or None."""
    oi, e1i, e2i, wi, hi = _frame(ci)
    oj, e1j, e2j, wj, hj = _frame(cj)
    ni = np.cross(e1i, e2i)
    nj = np.cross(e1j, e2j)
    d = np.cross(ni, nj)
    norm_d = np.linalg.norm(d)
    if norm_d < 1e-12:
        return None  # parallel planes
    d = d / norm_d
    # a point on the intersection line: solve [ni; nj; d] p = [ni.oi, nj.oj, d.oi]
    A = np.stack([ni, nj, d])
    b = np.array([ni @ oi, nj @ oj, d @ oi])
    p0 = np.linalg.solve(A, b)

    def clip(origin, e1, e2, w, h):
        """Parameter interval of {p0 + t d} inside the rectangle chart."""
        q = np.array([(p0 - origin) @ e1, (p0 - origin) @ e2])
        v = np.array([d @ e1, d @ e2])
        lo, hi = -np.inf, np.inf
        for k, bound in ((0, w), (1, h)):
            if abs(v[k]) < 1e-14:
                if q[k] < -_TOL or q[k] > bound + _TOL:
                    return None
            else:
                t0 = (0.0 - q[k]) / v[k]
                t1 = (bound - q[k]) / v[k]
                lo = max(lo, min(t0, t1))
                hi = min(hi, max(t0, t1))
        return (lo, hi) if hi > lo + _TOL else None

    Ii = clip(oi, e1i, e2i, wi, hi)
    Ij = clip(oj, e1j, e2j, wj, hj)
    if Ii is None or Ij is None:
        return None
    lo = max(Ii[0], Ij[0])
    hi = min(Ii[1], Ij[1])
    if hi <= lo + _TOL:
        return None
    return np.stack([p0 + lo * d, p0 + hi * d])


def _split_segments_at_points(seg_list, point_list):
    """Split 3D segments at any listed point lying strictly inside them."""
    out = []
    for seg in seg_list:
        a, b = seg
        d = b - a
        length = np.linalg.norm(d)
        ts = [0.0, 1.0]
        for p in point_list:
            t = (p - a) @ d / (length**2)
            if _TOL / length < t < 1 - _TOL / length:
                if np.linalg.norm(a + t * d - p) < 1e-9 * max(1.0, length):
                    ts.append(float(t))
        # merge parameters that are numerically the same point (two traces
        # ending at one junction produce two float copies of the same t)
        ts = np.unique(np.round(np.sort(np.asarray(ts)) / 1e-9) * 1e-9)
        for t0, t1 in zip(ts[:-1], ts[1:]):
            if (t1 - t0) * length > 1e-9:
                out.append(np.stack([a + t0 * d, a + t1 * d]))
    return out


def _segment_intersections_3d(segments):
    """All pairwise intersection points of 3D segments (within tol)."""
    pts = []
    for i in range(len(segments)):
        for j in range(i + 1, len(segments)):
            a1, b1 = segments[i]
            a2, b2 = segments[j]
            d1 = b1 - a1
            d2 = b2 - a2
            # closest points of the two lines
            r = a1 - a2
            a = d1 @ d1
            e = d2 @ d2
            f = d2 @ r
            c = d1 @ r
            bb = d1 @ d2
            denom = a * e - bb * bb
            if abs(denom) < 1e-14:
                continue
            s = (bb * f - c * e) / denom
            t = (a * f - bb * c) / denom
            if -_TOL <= s <= 1 + _TOL and -_TOL <= t <= 1 + _TOL:
                p1 = a1 + s * d1
                p2 = a2 + t * d2
                if np.linalg.norm(p1 - p2) < 1e-9:
                    pts.append(0.5 * (p1 + p2))
    return pts


def build_fracture_network(
    fractures: Sequence,
    h: float,
    boundary_marker: int = 1,
    boundary_markers: Optional[Sequence] = None,
    tol: float = 1e-9,
    *,
    device=None,
    dtype=None,
) -> FractureNetworkMesh:
    """Mesh a network of planar rectangular fractures conformally.

    Args:
      fractures: list of (4, 3) corner arrays (ordered around each rectangle).
      h: target edge length (same physical scale on every fracture).
      boundary_marker: vertex label for outer boundaries (Dirichlet = 1 by
        convention); ``boundary_markers`` may give per-fracture, per-side
        (4,) labels instead (e.g. 2 for an inflow side).

    Returns a glued :class:`FractureNetworkMesh` on ``device`` (default: the
    card, see ``config.resolve_device``).
    """
    config.resolve_device(device)  # fail before the host work, not after
    corners = [rectangle_fracture(c) for c in fractures]
    F = len(corners)
    frames = [_frame(c) for c in corners]

    # pairwise traces in 3D
    raw_traces = {}
    for i in range(F):
        for j in range(i + 1, F):
            seg = _trace_segment(corners[i], corners[j])
            if seg is not None:
                raw_traces[(i, j)] = seg

    # split all traces at mutual intersection points (triple points) AND at
    # other traces' endpoints: partially overlapping *collinear* traces
    # (three fractures sharing a line over different extents) have no
    # transversal intersection point, but must still break at each other's
    # ends so the per-fracture duplicate-segment dedup below sees exact
    # copies instead of un-meshable partial overlaps
    all_segs = list(raw_traces.values())
    cross_points = _segment_intersections_3d(all_segs)
    endpoints = [s[0] for s in all_segs] + [s[1] for s in all_segs]
    traces_per_pair = {
        pair: _split_segments_at_points([seg], cross_points + endpoints)
        for pair, seg in raw_traces.items()
    }

    # assemble per-fracture PSLGs
    triangulations = []
    anchors_2d = np.tile(np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]), (F, 1, 1))
    corners_3d = np.stack(
        [np.stack([o, o + e1, o + e2]) for (o, e1, e2, _, _) in frames]
    )

    for f in range(F):
        o, e1, e2, w, hh = frames[f]
        # boundary sides (in order), each possibly split by trace endpoints
        side_pts_3d = [
            np.stack([corners[f][0], corners[f][1]]),
            np.stack([corners[f][1], corners[f][2]]),
            np.stack([corners[f][2], corners[f][3]]),
            np.stack([corners[f][3], corners[f][0]]),
        ]
        if boundary_markers is not None:
            side_marks = list(np.asarray(boundary_markers[f]).reshape(4))
        else:
            side_marks = [boundary_marker] * 4

        my_traces = []
        for (i, j), segs in traces_per_pair.items():
            if f in (i, j):
                my_traces.extend(segs)

        trace_endpoints = [s[0] for s in my_traces] + [s[1] for s in my_traces]

        sides_split = []
        side_marks_split = []
        for side, mark in zip(side_pts_3d, side_marks):
            pieces = _split_segments_at_points([side], trace_endpoints)
            sides_split.extend(pieces)
            side_marks_split.extend([mark] * len(pieces))

        segs3d = sides_split + my_traces
        markers = side_marks_split + [0] * len(my_traces)

        # vertex pool (2D, deduped; tolerance-robust — trace endpoints and
        # rectangle corners reach the same point through different float
        # paths, see mesh/dedup.py)
        from .dedup import tolerant_group

        pts3d = np.concatenate([s for s in segs3d], axis=0)  # (2S, 3)
        pts2d = _to2d(pts3d, o, e1, e2)
        scale = max(1.0, np.abs(pts2d).max())
        inv = tolerant_group(pts2d, tol * scale)
        order = np.unique(inv, return_index=True)[1]
        remap = {int(g): k for k, g in enumerate(inv[np.sort(order)])}
        vert2d = pts2d[np.sort(order)]
        seg_idx = np.array(
            [[remap[int(inv[2 * s])], remap[int(inv[2 * s + 1])]] for s in range(len(segs3d))]
        )

        lengths3d = np.array(
            [np.linalg.norm(s[1] - s[0]) for s in segs3d]
        )
        divisions = np.maximum(1, np.ceil(lengths3d / h - 1e-9)).astype(np.int64)

        # a trace can coincide with a boundary side of this fracture (it is
        # interior only to the *other* fracture): after splitting, such pairs
        # are exact duplicates — keep one copy with the stronger marker and
        # the finer division count
        markers = np.asarray(markers)
        key = np.sort(seg_idx, axis=1)
        uniq_key, first, inv2 = np.unique(
            key, axis=0, return_index=True, return_inverse=True
        )
        uniq_markers = np.zeros(len(uniq_key), dtype=markers.dtype)
        np.maximum.at(uniq_markers, inv2, markers)
        uniq_divisions = np.zeros(len(uniq_key), dtype=divisions.dtype)
        np.maximum.at(uniq_divisions, inv2, divisions)
        seg_idx = uniq_key
        markers = uniq_markers
        divisions = uniq_divisions

        tri = triangulate_pslg(
            vert2d,
            seg_idx,
            h=h,
            segment_markers=markers,
            divisions=divisions,
        )
        triangulations.append(tri)

    return FractureNetworkMesh(
        triangulations, corners_3d, anchor_vertices_2d=anchors_2d, tol=tol,
        device=device, dtype=dtype,
    )
