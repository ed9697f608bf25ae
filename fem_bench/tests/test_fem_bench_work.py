"""The SpMV's work, counted from the mesh input, against hand counts."""

import numpy as np

from fem_bench import work
from fem_bench.meshes.kuhn_cube import kuhn_cube
from fem_bench.reference import kuhn_cube as cube_glue
from fem_bench.reference import network_npz as network_glue


def _grid(n):
    """A (n x n)-vertex chart of [0, n-1]^2, squares cut along (i, j)-(i+1, j+1)."""
    v = np.array([(i, j) for i in range(n) for j in range(n)], dtype=np.float64)
    labels = ((v == 0) | (v == n - 1)).any(1).astype(np.int8)
    tris = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b, c, d = i * n + j, (i + 1) * n + j, i * n + j + 1, (i + 1) * n + j + 1
            tris += [(a, b, d), (a, d, c)]
    return v, labels, np.array(tris)


def two_fractures():
    """Fracture A: 4 x 4 vertices on [0,3]^2 in z = 0; fracture B: 4 x 4 on
    y in [0,3], z in [-1,2] in the plane x = 1, sharing A's row x = 1."""
    v, lab, tri = _grid(4)
    return {
        "vertices": np.concatenate([v, v]), "labels": np.concatenate([lab, lab]),
        "triangles": np.concatenate([tri, tri]),
        "vertex_counts": np.array([16, 16]), "triangle_counts": np.array([18, 18]),
        # chart (s, t) -> A: (s, t, 0); B: (1, s, t - 1)
        "anchors_2d": np.array([[[0, 0], [1, 0], [0, 1]]] * 2, dtype=np.float64),
        "corners_3d": np.array([[[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                [[1, 0, -1], [1, 1, -1], [1, 0, 0]]], dtype=np.float64),
        "glue_tol": 1e-9,
    }


def test_two_fractures_hand_count():
    """A alone: 4 interior nodes, 5 edges among them: 4 + 2 x 5 = 14. B adds
    2 interior nodes (its row t = 1 is A's x = 1 interior row) and 4 new
    edges (its fifth is A's): 14 + 2 + 8 = 24 nonzeros on 6 rows."""
    g = network_glue.glue(two_fractures())
    assert len(g.dirichlet) == 28  # 32 vertices, 4 shared
    assert work.reduced_nonzeros(g.cells, g.dirichlet) == (24, 6)
    assert work.spmv_bytes(24, 6, 4, 4) == 24 * 8 + 7 * 4 + 2 * 6 * 4


def test_kuhn_cube_hand_count():
    """kuhn_cube(3): 8 interior nodes in a 2 x 2 x 2 block; edges along the
    3 axes (12), the 3 face diagonals e_a + e_b (6) and (1, 1, 1) (1):
    8 + 2 x 19 = 46."""
    v, t = kuhn_cube(3)
    assert v.shape == (64, 3) and t.shape == (6 * 27, 4)
    e = v[t[:, 1:]] - v[t[:, :1]]
    assert (np.linalg.det(e) > 0).all()
    g = cube_glue.glue({"vertices": v, "tetrahedra": t})
    assert work.reduced_nonzeros(g.cells, g.dirichlet) == (46, 8)


def test_roofline_takes_the_larger_bound():
    nnz, rows = 46, 8
    assert work.roofline_s(nnz, rows, 8, 8) == work.spmv_bytes(nnz, rows, 8, 8) / work.HBM_BYTES_PER_S
