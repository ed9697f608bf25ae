"""PyTorch port, the face bases and adaptive tet bisection
(``ElementTriSurface``, ``InteriorFacesBasis``, ``BoundaryFacesBasis``,
``refine_adaptive_tet``, ``MeshTet.refined``, ``bench.adaptive_tet``).

In float64 on the CPU, against the JAX package on the same inputs: the
Gram determinant and pseudo-inverse of triangle charts in R^3 (and R^2) to
1e-13; the P1-P3 DOF tables of both face bases byte-identical and their
quadrature tables to 1e-12; the two-sided and one-sided traces of P1-P3
cell bases onto them (tensor and callable form) to 1e-12; the
``TypeError`` for a plain ``ElementTri``; ``refine_adaptive_tet`` and
``MeshTet.refined`` byte-identical over 3 rounds on ``fichera_corner(2)``;
three levels of ``examples/example_adaptive_3d.py`` at its own size
(energy and eta to 1e-10, the port's own Dörfler marks equal to JAX's);
``interop.structure_from_numpy`` on a tet BSR structure.
"""

import importlib.util
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.element import ElementTet as JElementTet
from pytorch_fem_solver_tpu.mesh import MeshTet as JMeshTet
from pytorch_fem_solver_tpu.mesh import fichera_corner as j_fichera_corner
from pytorch_fem_solver_tpu.mesh import refine_adaptive_tet as j_refine_adaptive_tet
from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.bench import adaptive_tet
from pytorch_fem_solver_tpu_torch.ops import bsr as pb

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
FACE_Q = 4
CELL_Q = {1: 2, 2: 4, 3: 5}
FACE_CASES = ("interior", "boundary")


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = np.abs(ref).max()
    return np.abs(ours - ref).max() / (scale if scale else 1.0)


@pytest.fixture(scope="module")
def mesh():
    """(JAX MeshTet, port MeshTet) of ``unit_cube(2)`` and a cache of the
    face bases built on it."""
    return JMeshTet(fem.mesh.unit_cube(2)), pt.MeshTet(pt.unit_cube(2), device="cpu"), {}


def _faces(mesh, case, order):
    """(JAX, port) face basis of ``case`` at ``order``, built once."""
    jm, pm, cache = mesh
    if (case, order) not in cache:
        jcls, pcls = ((fem.InteriorFacesBasis, pt.InteriorFacesBasis) if case == "interior"
                      else (fem.BoundaryFacesBasis, pt.BoundaryFacesBasis))
        cache[case, order] = (jcls(jm, fem.ElementTriSurface(order, FACE_Q)),
                              pcls(pm, pt.ElementTriSurface(order, FACE_Q)))
    return cache[case, order]


@pytest.mark.parametrize("d", [2, 3])
def test_element_tri_surface_det_and_pinv_match_jax(d):
    rng = np.random.default_rng(d)
    jac = rng.standard_normal((6, d, 2))
    det, pinv = pt.ElementTriSurface(1, 2).compute_det_and_inv_map(torch.tensor(jac))
    jdet, jpinv = fem.ElementTriSurface(1, 2).compute_det_and_inv_map(jnp.asarray(jac))
    assert det.shape == (6, 1, 1, 1) and pinv.shape == (6, 1, 2, d)
    assert _rel(det.numpy(), jdet) <= 1e-13 and _rel(pinv.numpy(), jpinv) <= 1e-13
    gram = np.einsum("tdi,tdj->tij", jac, jac)
    np.testing.assert_allclose(det.numpy()[:, 0, 0, 0], np.sqrt(np.linalg.det(gram)), rtol=1e-13)
    np.testing.assert_allclose(pinv.numpy()[:, 0], np.linalg.pinv(jac), rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("case", FACE_CASES)
def test_face_dof_tables_byte_identical(mesh, case, order):
    jF, pF = _faces(mesh, case, order)
    assert pF.n_dofs == jF.n_dofs
    for name in ("_global_dofs4elements", "_nodes4boundary_dofs"):
        ours = getattr(pF, name)
        assert ours.dtype == torch.int32, name
        np.testing.assert_array_equal(ours.numpy(), np.asarray(getattr(jF, name)), err_msg=name)
    np.testing.assert_array_equal(pF._coords4global_dofs.numpy(), np.asarray(jF._coords4global_dofs))
    np.testing.assert_array_equal(pF._coords4elements.numpy(), np.asarray(jF._coords4elements))
    for key in ("bilinear_form_idx", "linear_form_idx"):
        for a, b in zip(pF._basis_parameters[key], jF._basis_parameters[key]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=key)
    np.testing.assert_array_equal(pF._basis_parameters["inner_dofs"].numpy(),
                                  np.asarray(jF._basis_parameters["inner_dofs"]))
    for name in ("v", "v_grad", "integration_points", "_dx", "_inv_map_jacobian"):
        assert _rel(getattr(pF, name).numpy(), getattr(jF, name)) <= 1e-12, name
    # the face's DOFs are the cell basis's ids of the same nodes
    pm = mesh[1]
    pV = pt.Basis(pm, pt.ElementTet(order, CELL_Q[order]))
    assert pF.n_dofs == pV.n_dofs
    np.testing.assert_array_equal(pF._coords4global_dofs.numpy(), pV._coords4global_dofs.numpy())


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("case", FACE_CASES)
def test_face_traces_match_jax(mesh, case, order):
    """Two-sided traces onto the interior faces ``(F, 2, q, 1, 1)`` and
    one-sided onto the boundary faces ``(F, 1, q, 1, 1)``, of a seeded DOF
    vector and of a function's nodal samples."""
    jm, pm, _ = mesh
    q = CELL_Q[order]
    jV, pV = fem.Basis(jm, JElementTet(order, q)), pt.Basis(pm, pt.ElementTet(order, q))
    jF, pF = _faces(mesh, case, 1)
    u = np.random.default_rng(order).standard_normal((pV.n_dofs, 1))
    vals, grads = pV.interpolate(pF, torch.tensor(u))
    jvals, jgrads = jV.interpolate(jF, jnp.asarray(u))
    sides = 2 if case == "interior" else 1
    assert vals.shape[:2] == (pF.integration_points.shape[0], sides) and grads.shape[-1] == 3
    assert _rel(vals.numpy(), jvals) <= 1e-12 and _rel(grads.numpy(), jgrads) <= 1e-12
    if case == "interior":  # the cells on both sides share the face's DOFs
        np.testing.assert_allclose(vals[:, 0].numpy(), vals[:, 1].numpy(), atol=1e-11)
    fn, fn_grad = pV.interpolate(pF)
    jfn, jfn_grad = jV.interpolate(jF)
    f = lambda c: c[..., 0:1] ** 2 + c[..., 1:2] * c[..., 2:3]  # noqa: E731
    assert _rel(fn(f).numpy(), jfn(f)) <= 1e-12
    assert _rel(fn_grad(f).numpy(), jfn_grad(f)) <= 1e-12


def test_face_bases_need_the_surface_element(mesh):
    pm = mesh[1]
    for cls in (pt.InteriorFacesBasis, pt.BoundaryFacesBasis):
        with pytest.raises(TypeError, match="ElementTriSurface"):
            cls(pm, pt.ElementTri(1, 2))


def _seeded_marks(n_cells, seed):
    return np.random.default_rng(seed).uniform(size=n_cells) < 0.2


def test_refine_adaptive_tet_and_refined_byte_identical():
    """Three rounds of seeded marks on ``fichera_corner(2)``: the host
    triangulations of ``refine_adaptive_tet`` and every table of
    ``MeshTet.refined`` equal the JAX package's."""
    jtri, ptri = j_fichera_corner(2), pt.fichera_corner(2)
    jm, pm = JMeshTet(jtri), pt.MeshTet(ptri, device="cpu")
    for rnd in range(3):
        marked = _seeded_marks(pm.n_cells, rnd)
        jtri = j_refine_adaptive_tet(jtri, marked)
        ptri = pt.refine_adaptive_tet(ptri, torch.as_tensor(marked))
        assert set(ptri) == set(jtri)
        for key in jtri:
            np.testing.assert_array_equal(ptri[key], jtri[key], err_msg=f"round {rnd} {key}")
        jm, pm = jm.refined(marked), pm.refined(marked)
        assert pm.device == torch.device("cpu") and pm.dtype == torch.float64
        assert isinstance(pm, pt.MeshTet)
        np.testing.assert_array_equal(pm["cells", "vertices"].numpy(), ptri["tetrahedra"])
        for group in ("vertices", "cells", "edges", "faces", "interior_faces", "boundary_faces"):
            for key, ref in jm[group].items():
                np.testing.assert_array_equal(pm[group, key].numpy(), np.asarray(ref),
                                              err_msg=f"round {rnd} {group} {key}")
    with pytest.raises(ValueError, match="entries"):
        pt.refine_adaptive_tet(ptri, np.zeros(3, dtype=bool))


def _example(name):
    sys.path.insert(0, str(EXAMPLES))
    try:
        spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(EXAMPLES))
    return module


def test_adaptive_3d_example_three_levels_match_jax():
    """``bench.adaptive_tet`` against ``examples/example_adaptive_3d.py`` at
    its own size (``fichera_corner(2)``, theta 0.4, tol 1e-10): DOFs,
    energy and eta to 1e-10 at each of 3 levels, the port's own Dörfler
    marks equal to the example's, the meshes equal."""
    ex = _example("example_adaptive_3d")
    levels = list(adaptive_tet(pt.fichera_corner(2), 3, ex.THETA, tol=1e-10, device="cpu"))
    tri = ex.fichera_corner(2)
    for level, lv in enumerate(levels):
        np.testing.assert_array_equal(lv.mesh["cells", "vertices"].numpy(), tri["tetrahedra"])
        n, energy, eta = ex.solve_and_estimate(tri)
        assert lv.n_dofs == n
        assert abs(lv.energy - energy) <= 1e-10 * abs(energy), (level, lv.energy, energy)
        assert lv.eta.shape == eta.shape and _rel(lv.eta, eta) <= 1e-10, level
        marks = ex.dorfler_mark(eta, theta=ex.THETA)
        differ = np.flatnonzero(lv.marked != marks)
        assert differ.size == 0, (level, differ[:20], np.abs(lv.eta - eta)[differ[:20]])
        tri = ex.refine_adaptive_tet(tri, marks)
    assert levels[0].mesh.n_cells < levels[1].mesh.n_cells < levels[2].mesh.n_cells
    assert levels[0].seconds["refine"] == 0.0 and levels[1].seconds["refine"] > 0.0
    assert "mesh" in levels[0].seconds


@pytest.mark.parametrize("max_b", [24, 8])
def test_structure_from_numpy_round_trips_a_tet_structure(max_b):
    """The JAX package's BSR structure of a P1 tet basis through
    ``interop`` equals the port's own: at the tets' default tier-1 width
    (24) and at 8, where rows spill into tier 2."""
    jm, pm = JMeshTet(fem.mesh.unit_cube(6)), pt.MeshTet(pt.unit_cube(6), device="cpu")
    jV, pV = fem.Basis(jm, JElementTet(1, 2)), pt.Basis(pm, pt.ElementTet(1, 2))
    assert pb.default_max_b(pV) == jb.default_max_b(jV) == 24
    jst = jb.get_bsr_structure(jV, max_b=max_b)
    pst = pb.get_bsr_structure(pV, max_b=max_b)
    assert (pst.heavy_rows.shape[0] > 0) == (max_b == 8)
    fields = {k: (v if isinstance(v, int) or v is None else np.asarray(v))
              for k, v in jst._asdict().items()}
    st = interop.structure_from_numpy(fields, device="cpu")
    for name in st._fields:
        a, b = getattr(st, name), getattr(pst, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name
