"""PyTorch port, the affine / rigid-body-mode two-level family against the
JAX package in float64.

Host tables: ``elasticity_rbm_modes`` and, for ``mode_kind`` affine, rbm
and components on a 2D and a 3D vector basis, W, Wb (NumPy's float64 QR in
both packages), bins1 and bins2 are byte-identical; the aggregate size
follows the JAX divisor search, also at the card's sizes. Numeric setup:
``coarse_inv``, ``blk_inv`` and ``inv_agg`` within 1e-12 relative, the
apply ``M(w)`` within 1e-12 and symmetric, with the 8x8 and the
aggregate-block smoother. The structure is cached on the basis per layout
and mode kind; a scalar basis asking for the rbm space raises the JAX
``ValueError``. Solves on ``unit_square(n=12)`` and ``unit_cube(4)``:
``solve_iterative(precondition="rbm")`` and ``"two_level"`` and the vector
``compiled_solver`` take the JAX iteration counts and agree to 1e-10; the
chunked vector solve (``chunk_cells=32``) is bitwise the unchunked one on
the CPU.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import precondition as pp

from test_torch_vector import elasticity, load

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REL = 1e-12
TOL = 1e-10


def _rel(ours, ref) -> float:
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300))


def _bases(dim):
    if dim == 2:
        return (
            fem.VectorBasis(fem.MeshTri(fem.unit_square(n=12)), fem.ElementTri(1, 4)),
            pt.VectorBasis(pt.MeshTri(pt.unit_square(n=12), device="cpu"), pt.ElementTri(1, 4)),
        )
    return (
        fem.VectorBasis(fem.MeshTet(fem.unit_cube(4)), fem.ElementTet(1, 2)),
        pt.VectorBasis(pt.MeshTet(pt.unit_cube(4), device="cpu"), pt.ElementTet(1, 2)),
    )


@pytest.fixture(scope="module", params=[2, 3], ids=["2d", "3d"])
def system(request):
    """Both packages' vector basis, BSR structure, assembled values and
    diagonal of the elasticity operator."""
    jV, pV = _bases(request.param)
    max_b = pb.default_max_b(pV)
    jst, pst = jb.get_bsr_structure(jV, max_b=max_b), pb.get_bsr_structure(pV, max_b=max_b)
    jvals = jb.bsr_values_from_local(jst, jV.integrate_bilinear_form_local(elasticity))
    pvals = pb.bsr_values_from_local(pst, pV.integrate_bilinear_form_local(elasticity))
    return SimpleNamespace(
        dim=request.param, jV=jV, pV=pV, jst=jst, pst=pst, jvals=jvals, pvals=pvals,
        jdiag=jb.bsr_diagonal(jst, jvals), pdiag=pb.bsr_diagonal(pst, pvals),
    )


@pytest.mark.parametrize("include_stretch", [False, True])
@pytest.mark.parametrize("nc,d", [(2, 2), (3, 3), (2, 3)])
def test_rbm_modes_byte_identical(nc, d, include_stretch):
    rng = np.random.default_rng(nc * 10 + d)
    coords = rng.standard_normal((60, d))
    comps = np.arange(60) % nc
    ref = jp.elasticity_rbm_modes(coords, comps, include_stretch=include_stretch)
    ours = pp.elasticity_rbm_modes(coords, comps, include_stretch=include_stretch)
    assert ours.dtype == ref.dtype and ours.shape == ref.shape
    assert ours.tobytes() == ref.tobytes()


@pytest.mark.parametrize("mode_kind", ["affine", "rbm", "components"])
def test_structure_byte_identical(system, mode_kind):
    s = system
    ref = jp.get_affine_two_level_structure(s.jV, s.jst, mode_kind=mode_kind)
    ours = pp.get_affine_two_level_structure(s.pV, s.pst, mode_kind=mode_kind)
    assert (ours.na, ours.g, ours.m) == (ref.na, ref.g, ref.m)
    m = {"affine": 1 + s.dim, "rbm": 1 + (s.dim - 1) + s.dim * (s.dim - 1) // 2,
         "components": s.dim}[mode_kind]
    assert ours.m == m
    for name in ("W", "Wb", "bins1", "bins2"):
        a, b = np.asarray(getattr(ref, name)), getattr(ours, name).numpy()
        assert b.dtype == a.dtype and b.shape == a.shape, name
        assert b.tobytes() == a.tobytes(), name
    assert ours.Wb.data_ptr() == ours.W.data_ptr()  # a view, as JAX's reshape


# (n_pad, m) -> (g, na): the card's three meshes of the rigid-body-mode
# coarse space; at 750,592 = 2^5 * 733 no divisor lies in [35, 140], so
# the search falls back downward and the coarse level exceeds 4,096
@pytest.mark.parametrize("n_pad,m,g,na", [
    (130_176, 3, 96, 1_356), (311_808, 6, 512, 609), (750_592, 6, 1_024, 733),
])
def test_aggregate_size_follows_jax(n_pad, m, g, na):
    st = SimpleNamespace(n_pad=n_pad, block=8)
    assert pp.default_affine_aggregate_size(st, m=m) == jp.default_affine_aggregate_size(st, m=m) == g
    assert n_pad // g == na
    assert pp.AFFINE_MAX_VECTORS == jp.AFFINE_MAX_VECTORS


@pytest.mark.parametrize("fine", ["block_jacobi", "agg_block", "jacobi"])
def test_numeric_setup_and_apply_match_jax(system, fine):
    s = system
    ref = jp.affine_two_level_from_values(
        jp.get_affine_two_level_structure(s.jV, s.jst, rbm=True), s.jst, s.jvals, s.jdiag, fine=fine
    )
    ours = pp.affine_two_level_from_values(
        pp.get_affine_two_level_structure(s.pV, s.pst, rbm=True), s.pst, s.pvals, s.pdiag, fine=fine
    )
    assert ours.gs == ref.gs
    assert _rel(ours.coarse_inv, ref.coarse_inv) <= REL
    assert _rel(ours.inv_diag, ref.inv_diag) <= REL
    for name in ("blk_inv", "inv_agg"):
        a, b = getattr(ref, name), getattr(ours, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(b, a) <= REL, name
    rng = np.random.default_rng(5)
    w, v = rng.standard_normal((2, s.pst.n_pad))
    Mw = ours(torch.from_numpy(w))
    assert _rel(Mw, ref(jnp.asarray(w))) <= REL
    # symmetric: v . M w == w . M v
    vMw, wMv = float(torch.from_numpy(v) @ Mw), float(torch.from_numpy(w) @ ours(torch.from_numpy(v)))
    assert abs(vMw - wMv) <= 1e-12 * abs(vMw)


def test_auto_preconditioner_takes_the_rbm_branch(system):
    s = system
    ref = jp.auto_preconditioner(s.jV, s.jst, s.jvals, s.jdiag)
    ours = pp.auto_preconditioner(s.pV, s.pst, s.pvals, s.pdiag)
    assert isinstance(ours, pp.AffineTwoLevel) and ours.gs == 0 and ours.inv_agg is None
    w = np.random.default_rng(9).standard_normal(s.pst.n_pad)
    assert _rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL


def test_structure_cache_and_scalar_raise(system):
    s = system
    a = pp.get_affine_two_level_structure(s.pV, s.pst, rbm=True)
    assert pp.get_affine_two_level_structure(s.pV, s.pst, mode_kind="rbm") is a
    c = pp.get_affine_two_level_structure(s.pV, s.pst, mode_kind="components")
    assert c is not a
    assert pp.get_affine_two_level_structure(s.pV, s.pst, mode_kind="components") is c
    keys = {k[-1] for k in s.pV._affine_two_level_structures}
    assert {"rbm", "components"} <= keys
    with pytest.raises(ValueError, match="unknown mode_kind"):
        pp.get_affine_two_level_structure(s.pV, s.pst, mode_kind="nope")
    jS = fem.Basis(fem.MeshTri(fem.unit_square(n=4)), fem.ElementTri(1, 2))
    pS = pt.Basis(pt.MeshTri(pt.unit_square(n=4), device="cpu"), pt.ElementTri(1, 2))
    for kind in ("rbm", "components"):
        with pytest.raises(ValueError) as ref:
            jp.get_affine_two_level_structure(jS, jb.get_bsr_structure(jS, max_b=8), mode_kind=kind)
        with pytest.raises(ValueError) as ours:
            pp.get_affine_two_level_structure(pS, pb.get_bsr_structure(pS, max_b=8), mode_kind=kind)
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("precondition,symmetric", [
    ("rbm", False), ("rbm", True), ("two_level", False), ("jacobi", False),
])
def test_solve_iterative_matches_jax(system, precondition, symmetric):
    s = system
    jb_vec, pb_vec = s.jV.integrate_linear_form(load), s.pV.integrate_linear_form(load)
    kw = dict(tol=TOL, precondition=precondition, symmetric_form=symmetric, return_info=True)
    u_ref, info_ref = s.jV.solve_iterative(s.jV.integrate_bilinear_form_local(elasticity), jb_vec, **kw)
    u, info = s.pV.solve_iterative(s.pV.integrate_bilinear_form_local(elasticity), pb_vec, **kw)
    assert bool(info.converged) and bool(info_ref.converged)
    assert info.iterations == int(info_ref.iterations)
    assert _rel(u, u_ref) <= TOL


def test_compiled_solver_matches_jax(system):
    s = system
    u_ref, info_ref = s.jV.compiled_solver(elasticity, load, tol=TOL)()
    u, info = s.pV.compiled_solver(elasticity, load, tol=TOL)()
    assert bool(info.converged)
    assert info.iterations == int(info_ref.iterations)
    assert _rel(u, u_ref) <= TOL
    # the direct-rhs and assembled-rhs paths agree, and a second solve on
    # the built tables is bitwise the first
    solve_b = s.pV.compiled_solver(elasticity, None, tol=TOL)
    u_b, info_b = solve_b(s.pV.integrate_linear_form(load))
    assert info_b.iterations == info.iterations and _rel(u_b, u_ref) <= TOL
    assert torch.equal(solve_b(s.pV.integrate_linear_form(load))[0], u_b)


def test_chunked_vector_solve_bitwise_unchunked():
    """The JAX package's ``test_compiled_chunked_vector_basis``: the cell
    count and n_loc come from the DOF map, not v_grad's component axes."""
    V = pt.VectorBasis(pt.MeshTri(pt.unit_square(n=10), device="cpu"), pt.ElementTri(1, 2))
    u_plain, info_plain = V.compiled_solver(elasticity, load, tol=1e-12)()
    u_chunk, info_chunk = V.compiled_solver(elasticity, load, tol=1e-12, chunk_cells=32)()
    assert torch.equal(u_chunk, u_plain) and info_chunk.iterations == info_plain.iterations
    jV = fem.VectorBasis(fem.MeshTri(fem.unit_square(n=10)), fem.ElementTri(1, 2))
    u_ref, info_ref = jV.compiled_solver(elasticity, load, tol=1e-12, chunk_cells=32)()
    assert info_chunk.iterations == int(info_ref.iterations)
    assert _rel(u_chunk, u_ref) <= 1e-10
