"""Conforming Delaunay triangulation of planar straight-line graphs (PSLGs).

Fills the role of the external ``triangle`` library in the reference
(``tr.triangulate({vertices, segments}, "pqsena...")``, e.g.
example_fractures_fem.py:44-46) with a native implementation:

1. every constraint segment is subdivided into sub-edges of length <= h
   (Steiner points), with an explicitly controllable division count so two
   meshes sharing a physical line can sample it identically (required for
   cross-fracture conformity in DFNs);
2. a background grid fills the domain interior, with a clearance band around
   constraint segments so their diametral circles stay empty;
3. scipy's Delaunay (qhull) triangulates the point set — with the clearance
   respected, all constraint sub-edges appear in the triangulation, which is
   verified and enforced;
4. if the boundary segments (nonzero markers) form closed loops, triangles
   outside the domain are discarded by even-odd containment — non-convex
   outlines and interior holes work; open boundaries fall back to the
   convex hull (identical result for convex domains);
5. optional ``min_angle``: Lloyd-style smoothing of the free background
   points until every triangle's minimum angle clears the floor (the role
   of the triangle library's "q" flag); raises if unattainable.

All host-side NumPy; runs once at setup. Quality metrics live in
``mesh.quality``.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import Delaunay

__all__ = ["triangulate_pslg", "segment_divisions"]


def _points_in_loops(points, loop_a, loop_b):
    """Even-odd containment of points w.r.t. closed boundary loops.

    loop_a/loop_b: (S, 2) segment endpoints. Half-open crossing rule keeps
    shared loop vertices from double-counting. Points ON the boundary are
    ambiguous — callers keep such points away via the clearance band.
    """
    x = points[:, 0:1]
    y = points[:, 1:2]
    x1, y1 = loop_a[:, 0][None], loop_a[:, 1][None]
    x2, y2 = loop_b[:, 0][None], loop_b[:, 1][None]
    crosses = (y1 <= y) != (y2 <= y)
    dy = np.where(y2 - y1 != 0, y2 - y1, 1.0)
    x_at = x1 + (y - y1) * (x2 - x1) / dy
    return ((crosses & (x < x_at)).sum(axis=1) % 2) == 1


def _closed_boundary(vertices, segments, segment_markers):
    """(seg_a, seg_b) of the boundary loops, or None if they don't close
    (every boundary vertex must have even incidence)."""
    boundary = segments[segment_markers != 0]
    if len(boundary) == 0:
        return None
    counts = np.bincount(boundary.reshape(-1), minlength=len(vertices))
    if (counts % 2 != 0).any():
        return None
    return vertices[boundary[:, 0]], vertices[boundary[:, 1]]


def segment_divisions(lengths: np.ndarray, h: float) -> np.ndarray:
    """Number of sub-edges per segment for target edge length h (>= 1)."""
    return np.maximum(1, np.ceil(np.asarray(lengths, dtype=float) / h)).astype(
        np.int64
    )


def _eval_size(size_field, points):
    """Evaluate a user size field -> positive (N,) local edge lengths."""
    s = np.asarray(size_field(np.asarray(points, dtype=np.float64)), dtype=float)
    s = s.reshape(len(points))
    if not (np.isfinite(s).all() and (s > 0).all()):
        raise ValueError("size_field must return finite positive lengths")
    return s


def _graded_ts(pa, pb, size_field, n_div=None):
    """Subdivision parameters (incl. endpoints) of segment pa->pb such that
    each sub-edge spans an ~equal integral of ds/size (arc length measured
    in local-size units); n_div defaults to ceil of that integral."""
    length = float(np.linalg.norm(pb - pa))
    tf = np.linspace(0.0, 1.0, 129)
    w = 1.0 / _eval_size(size_field, pa[None] + tf[:, None] * (pb - pa)[None])
    cum = np.concatenate(
        [[0.0], np.cumsum(0.5 * (w[1:] + w[:-1]) * np.diff(tf))]
    )
    if n_div is None:
        n_div = max(1, int(np.ceil(cum[-1] * length)))
    return np.interp(np.linspace(0.0, cum[-1], n_div + 1), cum, tf)


def _sample_segments(vertices, segments, divisions, size_field=None):
    """Steiner points on each segment (excluding endpoints).

    Returns (points (M, 2), owner_segment (M,)) plus, per segment, the index
    chain [v0, s..., v1] describing its sub-edges — endpoint indices refer to
    the input vertex array; interior samples are offset later. With a
    size_field, points are placed at equal quantiles of the 1/size integral
    (shorter sub-edges where the field is small).
    """
    points = []
    chains = []
    owners = []
    count = 0
    for s, (a, b) in enumerate(segments):
        pa, pb = vertices[a], vertices[b]
        if size_field is None:
            n_div = int(divisions[s])
            ts = np.linspace(0.0, 1.0, n_div + 1)[1:-1]
        else:
            n_div = None if divisions is None else int(divisions[s])
            ts = _graded_ts(pa, pb, size_field, n_div)[1:-1]
        seg_pts = pa[None] + ts[:, None] * (pb - pa)[None]
        idx = np.arange(count, count + len(seg_pts))
        chains.append((a, idx, b))
        owners.extend([s] * len(seg_pts))
        points.append(seg_pts)
        count += len(seg_pts)
    all_pts = (
        np.concatenate(points, axis=0) if points else np.zeros((0, 2))
    )
    return all_pts, np.asarray(owners, dtype=np.int64), chains


def _graded_background(lo, hi, size_field):
    """Quadtree-banded background points for a graded size field.

    Level-k points live on a grid of spacing s_max/2^k and are kept only
    where the local size falls in that level's band — factor-2 density
    jumps that the density-weighted Lloyd smoothing then relaxes.
    """
    extent = float(max(hi[0] - lo[0], hi[1] - lo[1]))
    # probe the size range over the bounding box
    px, py = np.meshgrid(
        np.linspace(lo[0], hi[0], 64), np.linspace(lo[1], hi[1], 64)
    )
    s_probe = _eval_size(
        size_field, np.stack([px.ravel(), py.ravel()], axis=-1)
    )
    s_min = float(s_probe.min())
    s_max = float(min(s_probe.max(), 0.5 * extent))
    if s_max <= s_min:
        s_max = s_min
    n_levels = int(np.ceil(np.log2(max(s_max / s_min, 1.0))))

    out = []
    for k in range(n_levels + 1):
        hk = s_max / 2**k
        # cell centers; odd levels half-offset to de-collinearize vs even
        off = 0.25 * hk if (k % 2) else 0.0
        xs = np.arange(lo[0] + 0.5 * hk + off, hi[0], hk)
        ys = np.arange(lo[1] + 0.5 * hk + off, hi[1], hk)
        if len(xs) == 0 or len(ys) == 0:
            continue
        gx, gy = np.meshgrid(xs, ys)
        grid_k = np.stack([gx.ravel(), gy.ravel()], axis=-1)
        s = np.maximum(_eval_size(size_field, grid_k), s_min)
        lvl = np.clip(
            np.floor(np.log2(s_max / s)), 0, n_levels
        ).astype(np.int64)
        out.append(grid_k[lvl == k])
    return (
        np.concatenate(out, axis=0) if out else np.zeros((0, 2))
    )


def _point_segment_distance(points, seg_a, seg_b):
    """Distance from each point to each segment: (N, S) matrix."""
    d = seg_b - seg_a  # (S, 2)
    len2 = (d**2).sum(-1)  # (S,)
    ap = points[:, None, :] - seg_a[None]  # (N, S, 2)
    t = np.clip((ap * d[None]).sum(-1) / np.where(len2 > 0, len2, 1.0), 0.0, 1.0)
    closest = seg_a[None] + t[..., None] * d[None]
    return np.linalg.norm(points[:, None, :] - closest, axis=-1)


def triangulate_pslg(
    vertices,
    segments,
    h: float,
    segment_markers=None,
    divisions=None,
    clearance: float = 0.45,
    max_retries: int = 3,
    min_angle: float | None = None,
    size_field=None,
):
    """Triangulate a PSLG with max edge length ~ h.

    Args:
      vertices: (n, 2) PSLG vertices (domain corners + segment endpoints).
      segments: (m, 2) vertex-index pairs (boundary + interior constraints).
      h: target edge length.
      segment_markers: (m,) int labels; 0 = interior constraint, nonzero =
        domain boundary (value preserved onto vertex labels). If the
        boundary segments form closed loops, non-convex outlines and holes
        are respected; otherwise the convex hull is meshed.
      divisions: (m,) explicit sub-edge counts (defaults from lengths/h) —
        pass shared counts to make two meshes conform along a common line.
      clearance: background points closer than clearance*h to any constraint
        are dropped (keeps constraint sub-edges Delaunay).
      min_angle: optional quality floor in degrees — free background points
        are Lloyd-smoothed until every triangle clears it (the triangle
        library's "q" role); RuntimeError if unattainable.
      size_field: optional callable (N, 2) points -> (N,) positive local
        target edge lengths — graded meshes (boundary layers, corner
        refinement), the role of the triangle library's per-region area
        constraints. Constraint segments are subdivided at equal quantiles
        of the 1/size integral, the background is a quadtree-banded point
        hierarchy matched to the field, and the free points are
        density-weighted Lloyd-smoothed. ``h`` then only scales the
        clearance fallback; spacing comes from the field.

    Returns a dict: vertices (N, 2), triangles (T, 3), vertex_markers (N, 1)
    in {0, 1}, vertex_labels (N, 1) carrying the originating segment marker,
    and h.
    """
    vertices = np.asarray(vertices, dtype=np.float64)
    segments = np.asarray(segments, dtype=np.int64)
    if segment_markers is None:
        segment_markers = np.ones(len(segments), dtype=np.int64)
    segment_markers = np.asarray(segment_markers, dtype=np.int64)

    seg_a = vertices[segments[:, 0]]
    seg_b = vertices[segments[:, 1]]
    if divisions is None and size_field is None:
        lengths = np.linalg.norm(seg_b - seg_a, axis=-1)
        divisions = segment_divisions(lengths, h)

    steiner, steiner_owner, chains = _sample_segments(
        vertices, segments, divisions, size_field
    )

    # background points over the domain hull interior
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    if size_field is None:
        nx = max(1, int(np.ceil((hi[0] - lo[0]) / h)))
        ny = max(1, int(np.ceil((hi[1] - lo[1]) / h)))
        gx, gy = np.meshgrid(
            np.linspace(lo[0], hi[0], nx + 1), np.linspace(lo[1], hi[1], ny + 1)
        )
        grid = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    else:
        grid = _graded_background(lo, hi, size_field)

    hull = Delaunay(vertices)
    inside = hull.find_simplex(grid) >= 0
    grid = grid[inside]

    # non-convex / holed domains: further restrict to the closed boundary
    # loops (no-op for convex outlines — on-boundary ambiguity is covered
    # by the clearance band, which drops all near-constraint grid points)
    loops = _closed_boundary(vertices, segments, segment_markers)
    if loops is not None:
        grid = grid[_points_in_loops(grid, *loops)]

    n_fixed = len(vertices)
    n_steiner = len(steiner)

    # constraint sub-edges as vertex-index pairs (attempt-independent)
    chain_edges = []
    for a, idx, b in chains:
        chain = np.concatenate(([a], n_fixed + idx, [b]))
        chain_edges.append(np.stack([chain[:-1], chain[1:]], axis=-1))
    chain_edges = (
        np.concatenate(chain_edges, axis=0)
        if chain_edges
        else np.zeros((0, 2), dtype=np.int64)
    )
    chain_edges = np.sort(chain_edges, axis=1)

    grid_dist = _point_segment_distance(grid, seg_a, seg_b).min(axis=1)
    # local clearance scale: global h, or the size field where graded
    grid_h = h if size_field is None else _eval_size(size_field, grid)

    def conforming_delaunay(all_points):
        """Delaunay + constraint-sub-edge presence check.

        Encodes undirected edges as a*N+b (a<b) and set-compares in NumPy.
        """
        simplices = Delaunay(all_points).simplices
        n_pts = len(all_points)
        edges = np.sort(
            simplices[:, [0, 1, 1, 2, 0, 2]].reshape(-1, 2), axis=1
        ).astype(np.int64)
        tri_codes = edges[:, 0] * n_pts + edges[:, 1]
        want_codes = chain_edges[:, 0] * n_pts + chain_edges[:, 1]
        return simplices, bool(
            np.isin(want_codes, tri_codes, assume_unique=False).all()
        )

    for attempt in range(max_retries):
        clear_scale = clearance * (1.0 + 0.5 * attempt)
        background = grid[grid_dist > clear_scale * grid_h]
        all_points = np.concatenate([vertices, steiner, background], axis=0)
        simplices, ok = conforming_delaunay(all_points)
        if ok:
            break
    else:
        raise RuntimeError(
            "PSLG triangulation failed to conform to constraint segments "
            f"after {max_retries} clearance expansions"
        )

    dropped_exterior = False

    def domain_filter(all_points, simplices):
        """Drop triangles outside the closed boundary loops (qhull meshes
        the convex hull; non-convex notches and holes get covered by
        triangles whose centroids lie outside the domain)."""
        nonlocal dropped_exterior
        if loops is None:
            return simplices
        centroids = all_points[simplices].mean(axis=1)
        keep = _points_in_loops(centroids, *loops)
        if not keep.all():
            dropped_exterior = True
        return simplices[keep]

    simplices = domain_filter(all_points, simplices)

    # sliver/degenerate-area threshold scale (finest resolution in play)
    h_fine = h if size_field is None else float(np.min(grid_h, initial=h))

    if min_angle is not None or size_field is not None:
        from .quality import triangle_min_angles

        def floor_angle(points, tris):
            # ignore the collinear slivers destined for the drop below
            p = points[tris]
            cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
                p[:, 1, 1] - p[:, 0, 1]
            ) * (p[:, 2, 0] - p[:, 0, 0])
            real = np.abs(cross) > 1e-12 * h_fine * h_fine
            return float(triangle_min_angles(points, tris[real]).min())

        free = np.arange(n_fixed + n_steiner, len(all_points))
        # without a quality floor (graded mesh), run a fixed relaxation
        # budget — the banded point hierarchy needs it to blend levels
        passes = 30 if min_angle is not None else 10
        for _ in range(passes):
            if min_angle is not None and floor_angle(all_points, simplices) >= min_angle:
                break
            # Lloyd-style step: move each free background point to the
            # density-weighted mean of its triangulation neighbors
            # (weight 1/size^2 keeps graded point budgets where the field
            # is small; uniform fields reduce to the plain mean)
            if size_field is None:
                wts = np.ones(len(all_points))
            else:
                wts = 1.0 / _eval_size(size_field, all_points) ** 2
            nbr_sum = np.zeros_like(all_points)
            nbr_cnt = np.zeros(len(all_points))
            e = simplices[:, [0, 1, 1, 2, 2, 0]].reshape(-1, 2)
            np.add.at(nbr_sum, e[:, 0], all_points[e[:, 1]] * wts[e[:, 1], None])
            np.add.at(nbr_cnt, e[:, 0], wts[e[:, 1]])
            np.add.at(nbr_sum, e[:, 1], all_points[e[:, 0]] * wts[e[:, 0], None])
            np.add.at(nbr_cnt, e[:, 1], wts[e[:, 0]])
            new_pts = all_points.copy()
            new_pts[free] = nbr_sum[free] / np.maximum(nbr_cnt[free, None], 1e-300)
            # smoothed points must stay out of the constraint clearance band
            d = _point_segment_distance(new_pts[free], seg_a, seg_b).min(axis=1)
            local_h = (
                h if size_field is None else _eval_size(size_field, new_pts[free])
            )
            reverted = d <= clear_scale * local_h
            new_pts[free[reverted]] = all_points[free[reverted]]
            new_simplices, ok = conforming_delaunay(new_pts)
            if not ok:
                break
            all_points = new_pts
            simplices = domain_filter(all_points, new_simplices)
        if min_angle is not None:
            achieved = floor_angle(all_points, simplices)
            if achieved < min_angle:
                raise RuntimeError(
                    f"min_angle={min_angle} deg not attained by smoothing "
                    f"(achieved {achieved:.2f} deg); refine h or relax the floor"
                )

    # drop zero-area slivers qhull may emit on collinear boundary points
    p = all_points[simplices]
    cross = (p[:, 1, 0] - p[:, 0, 0]) * (p[:, 2, 1] - p[:, 0, 1]) - (
        p[:, 1, 1] - p[:, 0, 1]
    ) * (p[:, 2, 0] - p[:, 0, 0])
    good = np.abs(cross) > 1e-12 * h_fine * h_fine
    simplices = simplices[good]
    cross = cross[good]
    # enforce positive orientation
    flip = cross < 0
    simplices[flip] = simplices[flip][:, [0, 2, 1]]

    # vertex labels: max marker over incident constraint segments
    labels = np.zeros(len(all_points), dtype=np.int64)
    np.maximum.at(labels, segments[:, 0], segment_markers)
    np.maximum.at(labels, segments[:, 1], segment_markers)
    if n_steiner:
        labels[n_fixed : n_fixed + n_steiner] = segment_markers[steiner_owner]

    if dropped_exterior:
        # compact vertices orphaned by the exterior-triangle drop (only a
        # non-convex/holed domain can orphan; convex output is unchanged)
        used = np.zeros(len(all_points), dtype=bool)
        used[simplices.reshape(-1)] = True
        remap = -np.ones(len(all_points), dtype=np.int64)
        remap[used] = np.arange(int(used.sum()))
        all_points = all_points[used]
        labels = labels[used]
        simplices = remap[simplices]

    markers = (labels > 0).astype(np.int64)

    return {
        "vertices": all_points,
        "triangles": simplices.astype(np.int64),
        "vertex_markers": markers.reshape(-1, 1),
        "vertex_labels": labels.reshape(-1, 1),
        "h": h,
    }
