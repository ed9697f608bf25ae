"""Tolerance-robust point deduplication for cross-fracture vertex glue.

The DFN glue identifies vertices shared between fractures by coordinates:
each fracture computes the same physical trace vertex through its own 2D
chart, so the 3D float values differ by O(eps * scale). A single rounding
grid (``round(c / tol)``) matches them *except* when the true coordinate
falls within float noise of a grid-cell boundary — then the two copies land
in adjacent cells and one physical DOF silently becomes two, breaking trace
continuity with no error (probability ~1e-6 per trace vertex, a real risk
at benchmark scale).

``tolerant_group`` removes that failure mode: exact grid grouping for the
bulk, then a KD-tree pass over the group representatives merges any groups
whose points are within the tolerance (boundary-straddling duplicates are
within float noise, far below the tolerance, while distinct mesh vertices
are >= h apart, far above it). Host-side, construction time only.
"""

from __future__ import annotations

import numpy as np

__all__ = ["tolerant_group"]


def tolerant_group(coords: np.ndarray, tol: float) -> np.ndarray:
    """Group points lying within ``tol`` of each other (absolute tolerance).

    Returns (n,) dense group ids. Grouping is exact-grid first (cell size
    ``tol``), then groups whose representatives are within ``tol`` are
    unioned, so duplicates straddling a cell boundary still coalesce.
    Distinct points must be separated by >> tol for the grouping to be
    well-posed (true for mesh vertices at any sane tolerance).
    """
    coords = np.asarray(coords, dtype=np.float64)
    n = coords.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int64)

    keys = np.round(coords / tol).astype(np.int64)
    _, inv = np.unique(keys, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    m = int(inv.max()) + 1

    first = np.full(m, n, dtype=np.int64)
    np.minimum.at(first, inv, np.arange(n))
    reps = coords[first]

    from scipy.spatial import cKDTree

    pairs = cKDTree(reps).query_pairs(r=tol, output_type="ndarray")

    parent = np.arange(m)

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return int(x)

    for i, j in pairs:
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[max(ri, rj)] = min(ri, rj)

    roots = np.fromiter((find(i) for i in range(m)), dtype=np.int64, count=m)
    _, dense = np.unique(roots, return_inverse=True)
    return dense.reshape(-1)[inv]
