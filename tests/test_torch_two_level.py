"""PyTorch port, the ELL two-level preconditioner family
(``ops/precondition.py``) and the Krylov loops (``ops/solvers.py``).

In float64 on the CPU, on the h=0.25 seven-fracture DFN (1,587 DOFs, so the
two-level M of ``gram_solver`` is built) and a unit square:
``spatial_aggregates`` and every ``TwoLevelStructure`` table byte-identical
to the JAX package; ``two_level_from_values``, ``build_two_level`` and
``auto_preconditioner`` values and one apply within 1e-12 relative;
``pcg`` from a non-zero ``x0``, ``cg`` and ``bicgstab`` (symmetric and
non-symmetric operators) in the JAX iteration count with solutions within
1e-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops import solvers as jsol
from pytorch_fem_solver_tpu.ops import sparse as js
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import precondition as pp
from pytorch_fem_solver_tpu_torch.ops import solvers as psol
from pytorch_fem_solver_tpu_torch.ops import sparse as ps

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REL = 1e-12
SOL = 1e-10


def _stiffness(b):
    if isinstance(b.v_grad, torch.Tensor):
        return b.v_grad @ b.v_grad.mT
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def _bases(mesh):
    if mesh == "dfn":
        jm = jax_network(h=0.25)
        pm = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jm._t), device="cpu")
        return (
            fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2)),
            pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2)),
        )
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(n=10)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.unit_square(n=10), device="cpu"), pt.ElementTri(1, 2)),
    )


@pytest.fixture(scope="module", params=["dfn", "square"])
def system(request):
    """Both packages' ELL stiffness operator (max_k=8) and its two-level
    tables on one mesh."""
    jV, pV = _bases(request.param)
    jst = js.get_ell_structure(jV, max_k=8)
    pst = ps.get_ell_structure(pV, max_k=8)
    jvals = js.ell_values_from_local(jst, jV.integrate_bilinear_form_local(_stiffness))
    pvals = ps.ell_values_from_local(pst, pV.integrate_bilinear_form_local(_stiffness))
    inner = np.asarray(jV._basis_parameters["inner_dofs"])
    coords = np.asarray(jV._coords4global_dofs)[inner]
    return {
        "jV": jV, "pV": pV, "jst": jst, "pst": pst, "jvals": jvals, "pvals": pvals,
        "jdiag": js.ell_diagonal(jst, jvals), "pdiag": ps.ell_diagonal(pst, pvals),
        "coords": coords,
        "jtl": jp.build_two_level_structure(jst, coords, leaf=32, kp=4),
        "ptl": pp.build_two_level_structure(pst, coords, leaf=32, kp=4),
    }


def _same_bytes(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    return ours.dtype == ref.dtype and ours.shape == ref.shape and ours.tobytes() == ref.tobytes()


def _rel(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("leaf", [5, 32])
@pytest.mark.parametrize("seed", [0, 1])
def test_spatial_aggregates_are_byte_identical_on_seeded_points(leaf, seed):
    # ties on purpose (a coarse grid of values): the stable argsort decides
    pts = np.round(np.random.default_rng(seed).uniform(size=(700, 3)) * 8) / 8
    assert _same_bytes(pp.spatial_aggregates(pts, leaf), jp.spatial_aggregates(pts, leaf))


def test_spatial_aggregates_of_the_interior_dofs_are_byte_identical(system):
    ours = pp.spatial_aggregates(system["coords"], 32)
    assert _same_bytes(ours, jp.spatial_aggregates(system["coords"], 32))
    assert ours.max() + 1 == system["ptl"].nc


@pytest.mark.parametrize("field", jp.TwoLevelStructure._fields)
def test_two_level_tables_are_byte_identical(system, field):
    ours, ref = getattr(system["ptl"], field), getattr(system["jtl"], field)
    if isinstance(ref, int):
        assert ours == ref
    else:
        assert _same_bytes(ours, ref), field


def test_two_level_from_values_and_one_apply_match_jax(system):
    s = system
    ref = jp.two_level_from_values(s["jtl"], s["jst"], s["jvals"], s["jdiag"])
    ours = pp.two_level_from_values(s["ptl"], s["pst"], s["pvals"], s["pdiag"])
    for field in ("inv_diag", "p_vals", "pt_vals", "coarse_inv"):
        assert _rel(getattr(ours, field), getattr(ref, field)) <= REL, field
    for field in ("p_cols", "pt_rows"):  # the apply's gathers widen them once
        ours_t = getattr(ours, field)
        assert ours_t.dtype == torch.int64, field
        assert np.array_equal(ours_t.numpy(), np.asarray(getattr(ref, field))), field
    r = np.random.default_rng(1).standard_normal(s["pst"].n_inner)
    assert _rel(ours(torch.from_numpy(r)), ref(jnp.asarray(r))) <= REL


@pytest.mark.parametrize("block", [32, 128])
def test_build_two_level_and_one_apply_match_jax(system, block):
    s = system
    ref = jp.build_two_level(s["jst"], s["jvals"], s["jdiag"], block=block)
    ours = pp.build_two_level(s["pst"], s["pvals"], s["pdiag"], block=block)
    assert (ours.block, ours.n, ours.n_pad) == (ref.block, ref.n, ref.n_pad)
    assert _rel(ours.coarse_inv, ref.coarse_inv) <= REL
    assert _rel(ours.inv_diag, ref.inv_diag) <= REL
    r = np.random.default_rng(2).standard_normal(s["pst"].n_inner)
    assert _rel(ours(torch.from_numpy(r)), ref(jnp.asarray(r))) <= REL


@pytest.mark.parametrize("system", ["dfn"], indirect=True)
def test_auto_preconditioner_matches_jax_and_caches_its_table(system):
    s = system
    jV, pV = s["jV"], s["pV"]
    jst = jb.get_bsr_structure(jV, max_b=8)
    pst = pb.get_bsr_structure(pV, max_b=8)
    local_j = jV.integrate_bilinear_form_local(_stiffness)
    local_p = pV.integrate_bilinear_form_local(_stiffness)
    jvals = jb.bsr_values_from_local(jst, local_j)
    pvals = pb.bsr_values_from_local(pst, local_p)
    ref = jp.auto_preconditioner(jV, jst, jvals, jb.bsr_diagonal(jst, jvals))
    ours = pp.auto_preconditioner(pV, pst, pvals, pb.bsr_diagonal(pst, pvals))
    assert (ours.g, ours.gs) == (ref.g, ref.gs)
    assert _rel(ours.inv_agg, ref.inv_agg) <= REL
    assert _rel(ours.coarse_inv, ref.coarse_inv) <= REL
    r = np.random.default_rng(3).standard_normal(pst.n_pad)
    assert _rel(ours(torch.from_numpy(r)), ref(jnp.asarray(r))) <= REL
    (table,) = pV._agg_block_tables.values()
    pp.auto_preconditioner(pV, pst, pvals, pb.bsr_diagonal(pst, pvals))
    assert next(iter(pV._agg_block_tables.values())) is table


def test_auto_preconditioner_vector_branch_raises():
    class Vector:
        n_components = 2

    with pytest.raises(NotImplementedError, match="A7"):
        pp.auto_preconditioner(Vector(), None, None, None)


def _pair(system, precond):
    """(port matvec, precond) and (JAX matvec, precond) of the system."""
    s = system
    pm = lambda v: ps.ell_matvec(s["pst"], s["pvals"], v)  # noqa: E731
    jm = lambda v: js.ell_matvec(s["jst"], s["jvals"], v)  # noqa: E731
    if precond == "two_level":
        return (
            (pm, pp.two_level_from_values(s["ptl"], s["pst"], s["pvals"], s["pdiag"])),
            (jm, jp.two_level_from_values(s["jtl"], s["jst"], s["jvals"], s["jdiag"])),
        )
    return (pm, None), (jm, None)


@pytest.mark.parametrize("precond", ["two_level", "jacobi"])
def test_pcg_from_a_nonzero_x0_matches_jax(system, precond):
    s = system
    (pm, pM), (jm, jM) = _pair(s, precond)
    rng = np.random.default_rng(4)
    n = s["pst"].n_inner
    b, x0 = rng.standard_normal(n), rng.standard_normal(n)
    x, info = psol.pcg(
        pm, torch.from_numpy(b), x0=torch.from_numpy(x0), precond=pM,
        precond_diag=s["pdiag"], tol=1e-12,
    )
    xr, info_r = jsol.pcg(
        jm, jnp.asarray(b), x0=jnp.asarray(x0), precond=jM,
        precond_diag=s["jdiag"], tol=1e-12,
    )
    assert info.iterations == int(info_r.iterations) > 0
    assert bool(info.converged) and bool(info_r.converged)
    assert _rel(x, xr) <= SOL
    # the start matters: the exact answer as x0 exits before one iteration
    _, again = psol.pcg(pm, torch.from_numpy(b), x0=x, precond=pM, tol=1e-10)
    assert again.iterations == 0


@pytest.mark.parametrize("precond", ["two_level", "jacobi"])
def test_bicgstab_matches_jax_on_the_spd_operator(system, precond):
    """To convergence, except on the DFN with point Jacobi: there BiCGStab
    amplifies roundoff (the two loops agree to 2e-16 after 5 iterations,
    7e-13 after 20 and 6e-9 after 30, and end 3 iterations apart), so that
    case holds the first 15 iterations instead."""
    s = system
    (pm, pM), (jm, jM) = _pair(s, precond)
    b = np.random.default_rng(5).standard_normal(s["pst"].n_inner)
    chaotic = s["pV"].n_dofs == 1587 and precond == "jacobi"
    cap = 15 if chaotic else None
    x, info = psol.bicgstab(pm, torch.from_numpy(b), precond=pM, precond_diag=s["pdiag"],
                            tol=1e-11, maxiter=cap)
    xr, info_r = jsol.bicgstab(jm, jnp.asarray(b), precond=jM, precond_diag=s["jdiag"],
                               tol=1e-11, maxiter=cap)
    assert info.iterations == int(info_r.iterations) > 0
    assert bool(info.converged) == bool(info_r.converged) == (not chaotic)
    assert _rel(x, xr) <= (1e-12 if chaotic else SOL)


def test_bicgstab_and_cg_match_jax_on_dense_systems():
    rng = np.random.default_rng(6)
    m = rng.standard_normal((80, 80))
    nonsym = 0.5 * m / np.sqrt(80) + np.eye(80)  # non-symmetric, spectrum in |z - 1| < 0.5
    spd = 0.25 * m @ m.T / 80 + np.eye(80)  # spectrum in [1, 2.1]
    b = rng.standard_normal(80)
    x0 = rng.standard_normal(80)
    for a in (nonsym, spd):
        x, info = psol.bicgstab(lambda v: torch.from_numpy(a) @ v, torch.from_numpy(b),
                                x0=torch.from_numpy(x0), precond_diag=torch.from_numpy(np.diag(a).copy()),
                                tol=1e-12)
        xr, info_r = jsol.bicgstab(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), x0=jnp.asarray(x0),
                                   precond_diag=jnp.asarray(np.diag(a).copy()), tol=1e-12)
        assert info.iterations == int(info_r.iterations)
        assert _rel(x, xr) <= SOL
    x, info = psol.cg(lambda v: torch.from_numpy(spd) @ v, torch.from_numpy(b), tol=1e-12)
    xr, info_r = jsol.cg(lambda v: jnp.asarray(spd) @ v, jnp.asarray(b), tol=1e-12)
    assert info.iterations == int(info_r.iterations)
    assert _rel(x, xr) <= SOL
    assert _rel(psol.dense_solve(torch.from_numpy(nonsym), torch.from_numpy(b)),
                jsol.dense_solve(jnp.asarray(nonsym), jnp.asarray(b))) <= SOL


def test_bicgstab_breakdown_freezes_the_state_as_jax_does():
    """A zero operator breaks down in the first iteration: both loops stop
    there, report non-convergence and keep x finite."""
    b = np.random.default_rng(7).standard_normal(10)
    x, info = psol.bicgstab(lambda v: 0.0 * v, torch.from_numpy(b), tol=1e-12)
    xr, info_r = jsol.bicgstab(lambda v: 0.0 * v, jnp.asarray(b), tol=1e-12)
    assert info.iterations == int(info_r.iterations) == 1
    assert not bool(info.converged) and not bool(info_r.converged)
    assert bool(torch.isfinite(x).all())
    np.testing.assert_array_equal(x.numpy(), np.asarray(xr))
