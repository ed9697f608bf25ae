"""PyTorch port, ``compiled_eigsh_solver`` (``AbstractBasis.compiled_eigsh``)
against the JAX package in float64: the compiled cases of the JAX
package's ``tests/test_eigen.py`` (LOBPCG against subspace iteration,
compiled against eager, the vector basis with the rigid-body-mode M) and
its eager vector case (``solve_eigsh`` on the elasticity pencil against a
dense oracle), plus Jacobi, the operator-product counts and
``matmul_precision``.

Held as in ``test_torch_eigen.py``: eigenvalues within rtol 1e-10 of the
JAX package's, round counts equal, M-orthonormality within 1e-9 and the
whole clusters' M-projectors within 1e-8. The solve returns ``(vals, vecs,
(rounds, eig_change, converged))`` with ``rounds`` a Python int and the
other two 0-dim tensors. The operator products, counted through a wrapper
of ``compiled.bsr_matvec``: 2 m + 6 m x rounds for LOBPCG (m the block
width), the count ``chip_smoke.py`` holds K2's launches to on the card; for
subspace iteration 3 m per round plus each inner PCG's iterations + 1.
"""

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_network
from pytorch_fem_solver_tpu_torch import bench, config
from pytorch_fem_solver_tpu_torch.ops import compiled, eigen
from test_torch_eigen import (
    a_form,
    check_basis_solve,
    check_modes,
    dense_spectrum,
    elasticity,
    m_form,
    reduced,
    vmass,
)

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]


def _square(max_area=0.5**8):
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(max_area=max_area)), fem.ElementTri(1, 3)),
        pt.Basis(pt.MeshTri(pt.unit_square(max_area=max_area), device="cpu"),
                 pt.ElementTri(1, 3)),
    )


def check_compiled(jV, pV, a, m, k, spectrum=None, **kw):
    """``compiled_eigsh`` of both packages; returns the port's solve and
    its result."""
    vals_ref, vecs_ref, (rounds_ref, change_ref, conv_ref) = jV.compiled_eigsh(a, m, k=k, **kw)()
    solve = pV.compiled_eigsh(a, m, k=k, **kw)
    vals, vecs, (rounds, change, conv) = out = solve()
    assert isinstance(rounds, int) and rounds == int(rounds_ref)
    assert change.dim() == 0 and conv.dtype == torch.bool and conv.dim() == 0
    assert bool(conv) is bool(conv_ref) is True
    assert vecs.shape == (pV.n_dofs, k)
    A, M = reduced(pV, a), reduced(pV, m)
    if spectrum is None:
        spectrum = dense_spectrum(A, M)
    inner = pV._basis_parameters["inner_dofs"].numpy()
    check_modes(vals, vecs[inner], vals_ref, np.asarray(vecs_ref)[inner], M, spectrum)
    return solve, out


def test_compiled_eigsh_lobpcg_matches_subspace():
    jV, pV = _square()
    _, (vals_s, _, _) = check_compiled(jV, pV, a_form, m_form, 4, tol=1e-9, method="subspace")
    _, (vals_l, _, _) = check_compiled(jV, pV, a_form, m_form, 4, tol=1e-9, method="lobpcg")
    np.testing.assert_allclose(vals_l.numpy(), vals_s.numpy(), rtol=1e-7)
    for V in (jV, pV):
        with pytest.raises(ValueError, match="method"):
            V.compiled_eigsh(a_form, m_form, k=2, method="arnoldi")


def test_compiled_eigsh_matches_eager():
    """The compiled solve (LOBPCG by default) agrees with the eager
    ``solve_eigsh`` (subspace iteration); a second call on the built
    tables gives the same bits."""
    jV, pV = _square()
    vals_e, _ = pV.solve_eigsh(a_form, m_form, k=4, tol=1e-9)
    solve, (vals_c, _, _) = check_compiled(jV, pV, a_form, m_form, 4, tol=1e-9)
    np.testing.assert_allclose(vals_c.numpy(), vals_e.numpy(), rtol=1e-8)
    vals_c2, _, _ = solve()
    assert torch.equal(vals_c2, vals_c)
    for V in (jV, pV):
        with pytest.raises(ValueError, match="unknown precondition"):
            V.compiled_eigsh(a_form, m_form, k=2, precondition="ilu")
        with pytest.raises(ValueError, match="eigenpairs from an n="):
            V.compiled_eigsh(a_form, m_form, k=10**6)


@pytest.mark.parametrize("method", ["subspace", "lobpcg"])
def test_elasticity_eigenmodes_vs_dense_oracle(method):
    """The vector pencil (elasticity stiffness, vector mass), inner solves
    or LOBPCG preconditioned by the rigid-body-mode M, against a dense
    whitened-eigh oracle on the same reduced matrices."""
    jV = fem.VectorBasis(fem.MeshTri(fem.unit_square(n=5)), fem.ElementTri(1, 2))
    pV = pt.VectorBasis(pt.MeshTri(pt.unit_square(n=5), device="cpu"), pt.ElementTri(1, 2))
    spectrum = dense_spectrum(reduced(pV, elasticity), reduced(pV, vmass))
    vals, _ = check_basis_solve(jV, pV, elasticity, vmass, 4, spectrum, tol=1e-10, method=method)
    np.testing.assert_allclose(vals, spectrum[:4], rtol=1e-7)


@pytest.mark.parametrize("method", ["lobpcg", "subspace"])
def test_compiled_eigsh_vector_rbm_two_level(method):
    """precondition='two_level' on a vector basis is the rigid-body-mode
    coarse space, and the compiled solve matches the eager one."""
    jV = fem.VectorBasis(fem.MeshTri(fem.unit_square(n=5)), fem.ElementTri(1, 2))
    pV = pt.VectorBasis(pt.MeshTri(pt.unit_square(n=5), device="cpu"), pt.ElementTri(1, 2))
    vals_e, _ = pV.solve_eigsh(elasticity, vmass, k=4, tol=1e-10)
    _, (vals_c, _, (rounds_c, _, _)) = check_compiled(jV, pV, elasticity, vmass, 4, tol=1e-10,
                                                      precondition="two_level", method=method)
    np.testing.assert_allclose(vals_c.numpy(), vals_e.numpy(), rtol=1e-7)
    assert len(pV._affine_two_level_structures) == 1
    # the bench workload of chip_smoke.py is this case at a given size
    r = bench.eigsh_elasticity(5, 4, method=method, tol=1e-10, solve_tol=1e-10, device="cpu",
                               dtype=torch.float64)
    assert torch.equal(r.vals, vals_c) and r.info[0] == rounds_c


def test_bench_eigsh_workloads():
    """``bench.eigsh_square`` (``tools/exp_solver_tier.py``'s "eigsh" at
    its tolerances, on ``rectangle(24, 24)``) and ``bench.eigsh_dfn`` (the
    h=0.25 two-fracture network) against the JAX package's compiled
    eigensolve of the same problems."""
    jV = fem.Basis(fem.MeshTri(fem.rectangle(24, 24)), fem.ElementTri(1, 3))
    check_bench(jV, bench.eigsh_square(24, device="cpu", dtype=torch.float64), tol=1e-5,
                solve_tol=1e-6)
    jV = fem.FractureNetworkBasis(jax_network([F1, F2], h=0.25), fem.ElementTri(1, 2))
    mesh = pt.build_fracture_network([F1, F2], h=0.25, device="cpu", dtype=torch.float64)
    check_bench(jV, bench.eigsh_dfn(mesh), tol=1e-5, solve_tol=1e-6)


def check_bench(jV, r, **kw):
    """A ``bench.EigshRun`` against the JAX package's compiled solve."""
    vals_ref, vecs_ref, (rounds_ref, _, conv_ref) = jV.compiled_eigsh(*r.forms, k=6, **kw)()
    rounds, _, conv = r.info
    assert rounds == int(rounds_ref) and bool(conv) is bool(conv_ref) is True
    inner = r.basis._basis_parameters["inner_dofs"].numpy()
    A, M = reduced(r.basis, r.forms[0]), reduced(r.basis, r.forms[1])
    check_modes(r.vals, r.vecs[inner], vals_ref, np.asarray(vecs_ref)[inner], M,
                dense_spectrum(A, M))


@pytest.mark.parametrize("method", ["lobpcg", "subspace"])
def test_compiled_eigsh_jacobi(method):
    jV, pV = _square(0.5**7)
    check_compiled(jV, pV, a_form, m_form, 3, tol=1e-9, precondition="jacobi", method=method)


def test_operator_product_counts(monkeypatch):
    """K2's launches per solve, counted on the CPU through the wrapper the
    solve calls: 2 m + 6 m x rounds for LOBPCG; 3 m per round plus every
    inner PCG's iterations + 1 for subspace iteration."""
    _, pV = _square(0.5**7)
    calls = [0]
    plain_mv = compiled.bsr_matvec

    def counted(st, values, x):
        calls[0] += 1
        return plain_mv(st, values, x)

    monkeypatch.setattr(compiled, "bsr_matvec", counted)
    k, m = 6, 9
    _, _, (rounds, _, conv) = pV.compiled_eigsh(a_form, m_form, k=k, tol=1e-8)()
    assert bool(conv) and calls[0] == 2 * m + 6 * m * rounds

    inner = []
    plain_pcg = eigen.pcg

    def pcg(*args, **kwargs):
        x, info = plain_pcg(*args, **kwargs)
        inner.append(info.iterations)
        return x, info

    monkeypatch.setattr(eigen, "pcg", pcg)
    calls[0] = 0
    _, _, (rounds, _, conv) = pV.compiled_eigsh(a_form, m_form, k=k, tol=1e-8,
                                                method="subspace", solve_tol=1e-8)()
    assert bool(conv) and len(inner) == m * rounds
    assert calls[0] == 3 * m * rounds + sum(i + 1 for i in inner)


def test_matmul_precision():
    """``"high"`` allows TF32 inside the solve only (no effect on the
    CPU); an unknown name raises before any table is built."""
    _, pV = _square(0.5**6)
    seen = []
    plain = pV.integrate_bilinear_form_local

    def spy(form):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return plain(form)

    pV.integrate_bilinear_form_local = spy
    before = torch.backends.cuda.matmul.allow_tf32
    vals_h, _, _ = pV.compiled_eigsh(a_form, m_form, k=2, matmul_precision="high")()
    assert seen == [True, True] and torch.backends.cuda.matmul.allow_tf32 is before is False
    seen.clear()
    vals, _, _ = pV.compiled_eigsh(a_form, m_form, k=2, matmul_precision=None)()
    assert seen == [False, False] and torch.equal(vals, vals_h)
    with pytest.raises(ValueError, match="unknown matmul_precision"):
        pV.compiled_eigsh(a_form, m_form, k=2, matmul_precision="bfloat16")
