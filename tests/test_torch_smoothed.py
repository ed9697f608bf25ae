"""PyTorch port, the smoothed-aggregation pair (``ops/precondition.py``:
the scipy host setup ``build_smoothed_two_level`` on the ELL operator and
the matrix-free ``smoothed_two_level_matrix_free`` on the BSR one) against
the JAX package in float64.

On the h=0.25 DFN (ELL with a spill tail) and ``unit_square(n=24)``, with
the same assembled values: ``p_cols`` and ``pt_rows`` (the restriction
rows padded with n) equal the JAX tables element for element, with the
truncation to ``max_row_nnz`` (3, 4) and without it, so the same entries
are kept; their weights, ``inv_diag`` and ``coarse_inv`` within 1e-12
relative; the apply on 3 seeded vectors within 1e-12; PCG in the JAX
iteration count, and in fewer iterations than Jacobi (the JAX package's
``tests/test_precondition.py`` claim). The matrix-free M: the apply within
1e-12 at two ``omega``, PCG in the JAX count, two SpMVs per apply.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops import solvers as jsol
from pytorch_fem_solver_tpu.ops import sparse as js
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import precondition as pp
from pytorch_fem_solver_tpu_torch.ops import solvers as psol
from pytorch_fem_solver_tpu_torch.ops import sparse as ps

from test_torch_three_level import REL, SOL, bases, bsr_system, rel, stiffness, vectors

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


@pytest.fixture(scope="module", params=["dfn", "square24"])
def ell(request):
    """Both packages' ELL stiffness operator (max_k=8), the JAX values
    handed to the port as the same numbers, the coordinates and the load."""
    if request.param == "dfn":
        jV, pV = bases("dfn")
    else:
        import pytorch_fem_solver_tpu as fem
        import pytorch_fem_solver_tpu_torch as pt

        jV = fem.Basis(fem.MeshTri(fem.unit_square(n=24)), fem.ElementTri(1, 2))
        pV = pt.Basis(pt.MeshTri(pt.unit_square(n=24), device="cpu"), pt.ElementTri(1, 2))
    jst, pst = js.get_ell_structure(jV, max_k=8), ps.get_ell_structure(pV, max_k=8)
    jvals = js.ell_values_from_local(jst, jV.integrate_bilinear_form_local(stiffness))
    pvals = tuple(torch.from_numpy(np.array(v)) for v in jvals)
    inner = np.asarray(jV._basis_parameters["inner_dofs"])
    b = np.array(jV.reduce(jV.integrate_linear_form(lambda v: v.v))[..., 0])
    return dict(jst=jst, pst=pst, jvals=jvals, pvals=pvals, b=b,
                coords=np.asarray(jV._coords4global_dofs)[inner],
                jdiag=js.ell_diagonal(jst, jvals), pdiag=ps.ell_diagonal(pst, pvals))


@pytest.mark.parametrize("leaf,max_row_nnz", [(32, 4), (16, 3), (16, None)])
def test_build_smoothed_two_level_matches_jax(ell, leaf, max_row_nnz):
    e = ell
    ref = jp.build_smoothed_two_level(e["jst"], e["jvals"], e["coords"], leaf=leaf,
                                      max_row_nnz=max_row_nnz)
    ours = pp.build_smoothed_two_level(e["pst"], e["pvals"], e["coords"], leaf=leaf,
                                       max_row_nnz=max_row_nnz)
    for name in ("p_cols", "pt_rows"):
        a, b = np.asarray(getattr(ref, name)).astype(np.int64), getattr(ours, name).numpy()
        assert b.dtype == np.int64 and a.shape == b.shape, name
        assert np.array_equal(a, b), name
    if max_row_nnz is not None:
        assert ours.p_cols.shape[1] <= max_row_nnz
    n = e["pst"].n_inner
    assert int(ours.pt_rows.max()) == n  # the padding row of the restriction
    for name in ("inv_diag", "p_vals", "pt_vals", "coarse_inv"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= REL, name
    # the kept entries: the nonzero weights sit where JAX's do
    assert np.array_equal(ours.p_vals.numpy() != 0, np.asarray(ref.p_vals) != 0)
    for w in vectors(n):
        assert rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL


def test_smoothed_pcg_matches_jax_and_beats_jacobi(ell):
    e = ell
    ref_m = jp.build_smoothed_two_level(e["jst"], e["jvals"], e["coords"], leaf=16,
                                        max_row_nnz=3)
    ours_m = pp.build_smoothed_two_level(e["pst"], e["pvals"], e["coords"], leaf=16,
                                         max_row_nnz=3)
    x_ref, info_ref = jsol.pcg(lambda v: js.ell_matvec(e["jst"], e["jvals"], v),
                               jnp.asarray(e["b"]), precond=ref_m, tol=1e-10)
    mv = lambda v: ps.ell_matvec(e["pst"], e["pvals"], v)  # noqa: E731
    b = torch.from_numpy(e["b"])
    x, info = psol.pcg(mv, b, precond=ours_m, tol=1e-10)
    _, info_j = psol.pcg(mv, b, precond_diag=e["pdiag"], tol=1e-10)
    assert info.iterations == int(info_ref.iterations)
    assert bool(info.converged) and info.iterations < info_j.iterations
    assert rel(x, x_ref) <= SOL


@pytest.fixture(scope="module", params=["dfn", "square"])
def system(request):
    return bsr_system(request.param)


@pytest.mark.parametrize("omega", [0.67, 0.8])
def test_matrix_free_apply_matches_jax(system, omega):
    s = system
    ref = jp.smoothed_two_level_matrix_free(s["jst"], s["jvals"], s["jdiag"], omega=omega)
    ours = pp.smoothed_two_level_matrix_free(s["pst"], s["pvals"], s["pdiag"], omega=omega)
    for w in vectors(s["pst"].n_pad):
        assert rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL


def test_matrix_free_pcg_matches_jax(system, monkeypatch):
    s = system
    ref_m = jp.smoothed_two_level_matrix_free(s["jst"], s["jvals"], s["jdiag"], omega=0.8)
    calls = []
    plain = pp.bsr_matvec
    monkeypatch.setattr(pp, "bsr_matvec", lambda *a: calls.append(1) or plain(*a))
    ours_m = pp.smoothed_two_level_matrix_free(s["pst"], s["pvals"], s["pdiag"], omega=0.8)
    x_ref, info_ref = jsol.pcg(lambda v: jb.bsr_matvec(s["jst"], s["jvals"], v),
                               jnp.asarray(s["b"]), precond=ref_m, tol=1e-10)
    x, info = psol.pcg(lambda v: pb.bsr_matvec(s["pst"], s["pvals"], v),
                       torch.from_numpy(s["b"]), precond=ours_m, tol=1e-10)
    assert info.iterations == int(info_ref.iterations) > 3
    # one M apply for r0 and one per iteration, two SpMVs each
    assert len(calls) == 2 * (info.iterations + 1)
    assert rel(x, x_ref) <= SOL
