"""PyTorch port, the public members and package namespaces the JAX package
has (the repairs C1 and C2 of ROADMAP.md).

C1: the mesh membership protocol (``key in mesh``: a group, a group and
leaf, an absent group, an absent leaf, a key past a leaf's dict),
``batch_size``, ``MeshTri.edge_permutations`` and
``ElementTri.outward_normal`` against the JAX package on
``unit_square(n=2)``, ``unit_cube(2)``, ``MeshesTri``, ``FracturesTri`` and
a two-fracture ``FractureNetworkMesh``; ``MeshTet`` inherits the first two
and keeps its own edge pairs.

C2: every package namespace of the port has an ``__all__`` equal to the
JAX package's less ``UNPORTED``, the names still queued in ROADMAP.md
(the list shrinks with queue A), every name in it resolves, and no name of
``UNPORTED`` exists in the port yet.
"""

import importlib

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_dfn
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.bench_vpinn import ANCHORS_2D, FRACTURES_3D

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]

# names of the JAX package's namespaces still queued in ROADMAP.md
UNPORTED = {
    "": set(),
    "basis": set(),
    "ops": set(),
    # the raw seven-fractures loaders read data this host does not have
    # (not queued)
    "utils": {"load_seven_fractures_raw", "seven_fractures_rectangles"},
    "parallel": set(),
    "element": set(),
    "mesh": set(),
    "models": set(),
    "native": set(),
}


@pytest.mark.parametrize("sub", sorted(UNPORTED))
def test_all_equals_jax_less_the_unported(sub):
    suffix = f".{sub}" if sub else ""
    jax_mod = importlib.import_module("pytorch_fem_solver_tpu" + suffix)
    port = importlib.import_module("pytorch_fem_solver_tpu_torch" + suffix)
    assert len(port.__all__) == len(set(port.__all__))
    assert set(port.__all__) == set(jax_mod.__all__) - UNPORTED[sub]
    assert UNPORTED[sub] <= set(jax_mod.__all__)
    for name in port.__all__:
        assert getattr(port, name) is not None
    for name in UNPORTED[sub]:
        assert not hasattr(port, name), f"{name} is ported: take it off UNPORTED"


def test_re_exports_are_the_modules_functions():
    from pytorch_fem_solver_tpu_torch.element import quadrature
    from pytorch_fem_solver_tpu_torch.mesh import quality
    from pytorch_fem_solver_tpu_torch.ops import solvers

    from pytorch_fem_solver_tpu_torch.ops import pcg

    assert pcg is solvers.pcg
    assert pt.element.tetrahedron_rule is quadrature.tetrahedron_rule
    assert pt.mesh.tet_quality_report is quality.tet_quality_report
    assert pt.quality_report is quality.quality_report
    assert pt.triangulate_pslg is pt.mesh.triangulate_pslg


def _pairs():
    tri = fem.rectangle(4, 2, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    ptri = pt.rectangle(4, 2, x0=-1.0, x1=1.0, y0=0.0, y1=1.0)
    return {
        "MeshTri": (fem.MeshTri(fem.unit_square(n=2)), pt.MeshTri(pt.unit_square(n=2), device="cpu")),
        "MeshTet": (fem.MeshTet(fem.unit_cube(2)), pt.MeshTet(pt.unit_cube(2), device="cpu")),
        "MeshesTri": (fem.MeshesTri([tri, tri, tri]), pt.MeshesTri([ptri, ptri, ptri], device="cpu")),
        "FracturesTri": (
            fem.FracturesTri([tri, tri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D),
            pt.FracturesTri([ptri, ptri], FRACTURES_3D, anchor_vertices_2d=ANCHORS_2D, device="cpu"),
        ),
        "FractureNetworkMesh": (
            jax_dfn([F1, F2], h=0.5), pt.build_fracture_network([F1, F2], h=0.5, device="cpu"),
        ),
    }


@pytest.fixture(scope="module")
def pairs():
    return _pairs()


@pytest.mark.parametrize(
    "name", ["MeshTri", "MeshTet", "MeshesTri", "FracturesTri", "FractureNetworkMesh"]
)
def test_membership_and_batch_size_match_jax(pairs, name):
    jm, pm = pairs[name]
    keys = [("cells", "vertices"), "cells", ("nope", "x"), "nope", ("cells", "nope"),
            ("interior_edges", "trace_mask"), ("faces", "vertices"), ("global", "markers")]
    for group, node in jm._t.items():
        keys.append(group)
        if isinstance(node, dict):
            keys += [(group, leaf) for leaf in node]
    for key in keys:
        assert (key in pm) == (key in jm), key
    assert ("cells", "vertices") in pm and ("nope", "x") not in pm and "nope" not in pm
    assert pm.batch_size() == jm.batch_size()


def test_mesh_tet_inherits_and_keeps_its_edges():
    assert pt.MeshTet.__contains__ is pt.MeshTri.__contains__
    assert pt.MeshTet.batch_size is pt.MeshTri.batch_size
    np.testing.assert_array_equal(pt.MeshTri.edge_permutations, fem.MeshTri.edge_permutations)
    np.testing.assert_array_equal(pt.MeshTet.edge_permutations, fem.MeshTet.edge_permutations)
    assert pt.MeshTri.edge_permutations.shape == (3, 2)
    assert pt.MeshTet.edge_permutations.shape == (6, 2)
    assert pt.MeshTri(pt.unit_square(n=2), device="cpu").edge_permutations is pt.MeshTri.edge_permutations


@pytest.mark.parametrize("dtype", [torch.float64, None])
def test_outward_normal_matches_jax(dtype):
    config.set_default_dtype(dtype)
    try:
        for element in (pt.ElementTri(1, 2), pt.ElementTri(2, 4), pt.ElementTriSurface(1, 2)):
            normal = element.outward_normal
            assert normal.dtype == config.default_dtype()
            np.testing.assert_array_equal(
                normal.numpy(), np.asarray(fem.ElementTri(1, 2).outward_normal)
            )
    finally:
        config.set_default_dtype(torch.float64)
