"""PyTorch port, point evaluation (``basis/basis.py``: ``Basis._locate_cells``
and ``Basis.probe``) against the JAX package in float64.

On ``unit_square(n=16)`` (P1 and P2), a P1 ``VectorBasis`` on
``unit_square(n=8)`` and P1 on ``unit_cube(3)``: the located cell ids are
the JAX ids element for element, for seeded points, the mesh's vertices
(on cell boundaries, where the first candidate that passes the test
wins) and points that only the widened 64-candidate or all-cell search
finds; values and gradients of a seeded DOF vector within 1e-12 relative;
a P1 probe reproduces an affine function to 1e-12; a point outside the
mesh raises the JAX text.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch import config

from test_torch_three_level import rel

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REL = 1e-12


def _pair(case):
    if case == "p1":
        return (fem.Basis(fem.MeshTri(fem.unit_square(n=16)), fem.ElementTri(1, 2)),
                pt.Basis(pt.MeshTri(pt.unit_square(n=16), device="cpu"), pt.ElementTri(1, 2)))
    if case == "p2":
        return (fem.Basis(fem.MeshTri(fem.unit_square(n=16)), fem.ElementTri(2, 4)),
                pt.Basis(pt.MeshTri(pt.unit_square(n=16), device="cpu"), pt.ElementTri(2, 4)))
    if case == "vector":
        return (fem.VectorBasis(fem.MeshTri(fem.unit_square(n=8)), fem.ElementTri(1, 2)),
                pt.VectorBasis(pt.MeshTri(pt.unit_square(n=8), device="cpu"),
                               pt.ElementTri(1, 2)))
    return (fem.Basis(fem.MeshTet(fem.unit_cube(3)), fem.ElementTet(1, 2)),
            pt.Basis(pt.MeshTet(pt.unit_cube(3), device="cpu"), pt.ElementTet(1, 2)))


def _points(pV, n=400, seed=0):
    """Seeded interior points plus the mesh's vertices (cell boundaries)."""
    verts = pV.mesh["vertices", "coordinates"].numpy()
    d = verts.shape[1]
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.0, 1.0, size=(n, d)), verts], axis=0)


@pytest.fixture(scope="module", params=["p1", "p2", "vector", "tet"])
def pair(request):
    return request.param, *_pair(request.param)


def test_located_cells_equal_jax(pair):
    _, jV, pV = pair
    pts = _points(pV)
    ref = jV._locate_cells(pts, 1e-10)
    ours = pV._locate_cells(pts, 1e-10)
    assert ours.dtype == np.int64 and np.array_equal(ours, ref)


def test_probe_values_and_gradients_match_jax(pair):
    case, jV, pV = pair
    pts = _points(pV, seed=1)
    u = np.random.default_rng(2).standard_normal((pV.n_dofs, 1))
    ref_v, ref_g = jV.probe(pts, jnp.asarray(u))
    v, g = pV.probe(pts, torch.from_numpy(u))
    nc = 2 if case == "vector" else None
    d = pts.shape[1]
    assert v.shape == ((len(pts), nc) if nc else (len(pts),))
    assert g.shape == ((len(pts), nc, d) if nc else (len(pts), d))
    assert v.dtype == torch.float64
    assert rel(v, ref_v) <= REL and rel(g, ref_g) <= REL


def test_p1_probe_reproduces_an_affine_function():
    _, pV = _pair("p1")
    coords = pV._coords4global_dofs.numpy()
    u = (1.5 + 2.0 * coords[:, 0] - 0.5 * coords[:, 1])[:, None]
    pts = _points(pV, seed=3)
    v, g = pV.probe(pts, torch.from_numpy(u))
    exact = 1.5 + 2.0 * pts[:, 0] - 0.5 * pts[:, 1]
    assert np.abs(v.numpy() - exact).max() <= 1e-12
    assert np.abs(g.numpy() - np.array([2.0, -0.5])).max() <= 1e-12


def _sliver_square(n=300, eps=0.01):
    """The unit square as one large triangle under its diagonal, a strip of
    2 n small triangles along the diagonal's far side and a fan to (1, 1):
    near the diagonal, hundreds of strip centroids lie closer than the large
    triangle's own."""
    t = np.arange(n + 1) / n
    p = np.stack([1 - t, t], axis=1)  # on the diagonal x + y = 1
    q = p + eps  # the strip's far side
    verts = np.concatenate([[[0.0, 0.0], [1.0, 1.0]], p, q])
    P, Q = 2 + np.arange(n + 1), 3 + n + np.arange(n + 1)
    k = np.arange(n)
    tris = np.concatenate([
        [[0, P[0], P[n]]],
        np.stack([P[k], P[k + 1], Q[k]], 1),
        np.stack([P[k + 1], Q[k + 1], Q[k]], 1),
        np.stack([np.ones(n, np.int64), Q[k + 1], Q[k]], 1),
    ])
    return {"vertices": verts, "triangles": tris}


def test_widened_search_finds_what_jax_finds():
    """(0.42, 0.42) lies in the large triangle behind ~54 closer strip
    centroids (found by the 64-candidate pass), (0.47, 0.47) behind more
    than 64 (the all-cell pass); the rest in the first 8."""
    tri = _sliver_square()
    jV = fem.Basis(fem.MeshTri(tri), fem.ElementTri(1, 2))
    pV = pt.Basis(pt.MeshTri(tri, device="cpu"), pt.ElementTri(1, 2))
    pts = np.array([[0.2, 0.2], [0.42, 0.42], [0.47, 0.47], [0.5, 0.505], [0.9, 0.9]])
    ref = jV._locate_cells(pts, 1e-10)
    ours = pV._locate_cells(pts, 1e-10)
    assert np.array_equal(ours, ref)
    assert list(ours[:3]) == [0, 0, 0]
    u = np.random.default_rng(4).standard_normal((pV.n_dofs, 1))
    v, g = pV.probe(pts, torch.from_numpy(u))
    ref_v, ref_g = jV.probe(pts, jnp.asarray(u))
    assert rel(v, ref_v) <= REL and rel(g, ref_g) <= REL


def test_outside_point_raises_the_jax_text():
    jV, pV = _pair("p1")
    far = np.array([[0.5, 0.5], [2.0, 0.5]])
    with pytest.raises(ValueError) as ref:
        jV.probe(far, jnp.zeros((jV.n_dofs, 1)))
    with pytest.raises(ValueError) as ours:
        pV.probe(far, torch.zeros((pV.n_dofs, 1)))
    assert str(ours.value) == str(ref.value)
