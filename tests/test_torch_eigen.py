"""PyTorch port, the generalized eigensolvers against the JAX package in
float64: ``ops.eigen.subspace_eigsh`` and ``lobpcg_eigsh`` on a dense
pencil, and ``AbstractBasis.solve_eigsh`` (both methods) on the scalar
cases of the JAX package's ``tests/test_eigen.py`` (its vector case is in
``test_torch_eigen_compiled.py``, beside the compiled vector case).

Both packages draw the start block from NumPy's ``default_rng(seed)``, so
they iterate from the same numbers. Held: eigenvalues within rtol 1e-10 of
the JAX package's, round counts equal, the M-orthonormality of the port's
eigenvectors within 1e-9, and, for every cluster of equal eigenvalues that
lies whole among the k returned (a cluster is a run of the dense oracle's
eigenvalues within 1e-6 relative), the M-projector ``X X^T M`` of the
cluster within 1e-8 of the JAX package's. Raw columns are never compared:
eigenvector signs differ between the two LAPACK calls, and inside a cluster
the vectors may rotate; the span and the eigenvalues do not. The JAX
test's own assertions (the dense oracle, the analytic Laplace spectrum from
above at O(h^2), finite ascending modes) are held on the port as well.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_network
from pytorch_fem_solver_tpu.ops.eigen import lobpcg_eigsh as jax_lobpcg
from pytorch_fem_solver_tpu.ops.eigen import subspace_eigsh as jax_subspace
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops.eigen import EighInfo, lobpcg_eigsh, subspace_eigsh

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

PI2 = math.pi**2
F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]
MU, LAM = 1.0, 1.5


def _m(b):
    return torch if isinstance(b.v, torch.Tensor) else jnp


def a_form(b):
    return b.v_grad @ b.v_grad.swapaxes(-1, -2)


def m_form(b):
    return b.v @ b.v.swapaxes(-1, -2)


def elasticity(b):
    g = b.v_grad
    eps = 0.5 * (g + g.swapaxes(-1, -2))
    div = g.diagonal(0, -2, -1).sum(-1) if _m(b) is jnp else g.diagonal(dim1=-2, dim2=-1).sum(-1)
    return (2 * MU * _m(b).einsum("...icd,...jcd->...ij", eps, eps)
            + LAM * div[..., :, None] * div[..., None, :])


def vmass(b):
    return _m(b).einsum("...ic,...jc->...ij", b.v, b.v)


def reduced(V, form):
    return V.reduce(V.integrate_bilinear_form(form)).numpy()


def dense_spectrum(A, M):
    li = np.linalg.inv(np.linalg.cholesky(M))
    return np.sort(np.linalg.eigvalsh(li @ A @ li.T))


def whole_clusters(spectrum, k, rtol=1e-6):
    """Index runs of equal eigenvalues (within ``rtol``) that lie whole
    among the first ``k``."""
    runs, start = [], 0
    for i in range(1, len(spectrum) + 1):
        if i == len(spectrum) or spectrum[i] - spectrum[i - 1] > rtol * abs(spectrum[i]):
            if i <= k:
                runs.append(list(range(start, i)))
            start = i
    return runs


def check_modes(vals, vecs, vals_ref, vecs_ref, M, spectrum):
    """Eigenvalues, M-orthonormality and the whole clusters' M-projectors
    (``vecs`` over the same rows as ``M``)."""
    k = len(vals_ref)
    np.testing.assert_allclose(vals.numpy(), np.asarray(vals_ref), rtol=1e-10)
    x, x_ref = vecs.numpy(), np.asarray(vecs_ref)
    assert np.abs(x.T @ M @ x - np.eye(k)).max() <= 1e-9
    for run in whole_clusters(spectrum, k):
        proj = x[:, run] @ x[:, run].T @ M
        proj_ref = x_ref[:, run] @ x_ref[:, run].T @ M
        assert np.abs(proj - proj_ref).max() <= 1e-8, run


def check_basis_solve(jV, pV, a, m, k, spectrum=None, **kw):
    """``solve_eigsh`` of both packages on the same forms; returns the
    port's eigenvalues and info."""
    vals_ref, vecs_ref, info_ref = jV.solve_eigsh(a, m, k=k, return_info=True, **kw)
    vals, vecs, info = pV.solve_eigsh(a, m, k=k, return_info=True, **kw)
    assert isinstance(info, EighInfo) and isinstance(info.iterations, int)
    assert info.iterations == info_ref.iterations
    assert bool(info.converged) is bool(info_ref.converged) is True
    assert vecs.shape == (pV.n_dofs, k)
    A, M = reduced(pV, a), reduced(pV, m)
    if spectrum is None:
        spectrum = dense_spectrum(A, M)
    inner = pV._basis_parameters["inner_dofs"].numpy()
    check_modes(vals, vecs[inner], vals_ref, np.asarray(vecs_ref)[inner], M, spectrum)
    # zeros on the Dirichlet DOFs
    outer = np.setdiff1d(np.arange(pV.n_dofs), inner)
    assert not vecs[outer].any()
    return vals.numpy(), info


def _pencil():
    rng = np.random.default_rng(0)
    n = 50
    q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    # graded spectrum: subspace iteration converges at (lam_i / lam_m)^rounds
    a = q @ np.diag(np.arange(1.0, n + 1) ** 2) @ q.T
    qm = rng.normal(size=(n, n)) * 0.1
    m = qm @ qm.T + np.eye(n)
    return rng, a, m


def test_subspace_eigsh_dense_oracle():
    _, a, m = _pencil()
    spectrum = dense_spectrum(a, m)
    aj, mj = jnp.asarray(a), jnp.asarray(m)
    at, mt = torch.from_numpy(a), torch.from_numpy(m)
    vals_ref, vecs_ref, info_ref = jax_subspace(
        lambda v: aj @ v, lambda v: mj @ v, n=50, k=4, tol=1e-11
    )
    vals, vecs, info = subspace_eigsh(
        lambda v: at @ v, lambda v: mt @ v, n=50, k=4, tol=1e-11, device="cpu"
    )
    assert info.converged and info.iterations == info_ref.iterations
    assert abs(info.eig_change - info_ref.eig_change) <= 1e-12
    np.testing.assert_allclose(vals.numpy(), spectrum[:4], rtol=1e-8)
    check_modes(vals, vecs, vals_ref, vecs_ref, m, spectrum)
    for j in range(4):
        x = vecs[:, j].numpy()
        r = a @ x - float(vals[j]) * (m @ x)
        assert np.linalg.norm(r) < 1e-6 * float(vals[j])
    # an explicit start block: the random default's own numbers
    x0 = torch.from_numpy(np.random.default_rng(0).standard_normal((50, 6)))
    vals_x0, _, info_x0 = subspace_eigsh(
        lambda v: at @ v, lambda v: mt @ v, n=50, k=4, tol=1e-11, x0=x0
    )
    assert torch.equal(vals_x0, vals) and info_x0 == info
    with pytest.raises(ValueError, match="x0 must be"):
        subspace_eigsh(lambda v: at @ v, lambda v: mt @ v, n=50, k=4, x0=x0[:, :5])


def test_lobpcg_dense_oracle():
    rng, a, m = _pencil()
    spectrum = dense_spectrum(a, m)
    x0 = rng.standard_normal((50, 6))
    aj, mj = jnp.asarray(a), jnp.asarray(m)
    at, mt = torch.from_numpy(a), torch.from_numpy(m)
    vals_ref, vecs_ref, (rounds_ref, change_ref, conv_ref) = jax_lobpcg(
        lambda v: aj @ v, lambda v: mj @ v, jnp.asarray(x0), 4, tol=1e-11,
        precond_diag=jnp.diag(aj),
    )
    vals, vecs, (rounds, change, conv) = lobpcg_eigsh(
        lambda v: at @ v, lambda v: mt @ v, torch.from_numpy(x0), 4, tol=1e-11,
        precond_diag=torch.diag(at),
    )
    assert isinstance(rounds, int) and rounds == int(rounds_ref)
    assert change.dim() == 0 and conv.dtype == torch.bool and conv.dim() == 0
    assert bool(conv) is bool(conv_ref) is True
    np.testing.assert_allclose(vals.numpy(), spectrum[:4], rtol=1e-9)
    check_modes(vals, vecs, vals_ref, vecs_ref, m, spectrum)
    # the sharded-path hook: an identity psum changes nothing
    vals_p, _, (rounds_p, _, _) = lobpcg_eigsh(
        lambda v: at @ v, lambda v: mt @ v, torch.from_numpy(x0), 4, tol=1e-11,
        precond_diag=torch.diag(at), psum=lambda g: g,
    )
    assert torch.equal(vals_p, vals) and rounds_p == rounds


@pytest.mark.parametrize("method", ["subspace", "lobpcg"])
def test_laplace_spectrum_unit_square(method):
    """The first 4 Dirichlet modes converge to pi^2 (2, 5, 5, 8) from
    above at O(h^2), in both packages alike."""
    exact = np.array([2.0, 5.0, 5.0, 8.0]) * PI2
    rel = []
    for ma in (0.5**7, 0.5**9):
        jV = fem.Basis(fem.MeshTri(fem.unit_square(max_area=ma)), fem.ElementTri(1, 3))
        pV = pt.Basis(pt.MeshTri(pt.unit_square(max_area=ma), device="cpu"), pt.ElementTri(1, 3))
        vals, _ = check_basis_solve(jV, pV, a_form, m_form, 4, tol=1e-8, method=method)
        assert (vals > exact).all()  # P1 Rayleigh quotients from above
        rel.append(np.abs(vals - exact) / exact)
    assert (rel[1] < rel[0] / 3).all(), (rel[0], rel[1])


def test_laplace_first_mode_unit_cube():
    jV = fem.Basis(fem.MeshTet(fem.unit_cube(6)), fem.ElementTet(1, 2))
    pV = pt.Basis(pt.MeshTet(pt.unit_cube(6), device="cpu"), pt.ElementTet(1, 2))
    vals, _ = check_basis_solve(jV, pV, a_form, m_form, 2, tol=1e-7)
    # P1 from above; ~12% discretisation error at h = 1/6
    assert 3 * PI2 < vals[0] < 1.2 * 3 * PI2


@pytest.mark.parametrize("method", ["subspace", "lobpcg"])
def test_dfn_eigenmodes_finite_and_orthonormal(method):
    """The glued two-fracture network at h=0.2: finite ascending modes,
    M-orthonormal across the traces."""
    jV = fem.FractureNetworkBasis(jax_network([F1, F2], h=0.2), fem.ElementTri(1, 2))
    pV = pt.FractureNetworkBasis(pt.build_fracture_network([F1, F2], h=0.2, device="cpu"),
                                 pt.ElementTri(1, 2))
    vals, _ = check_basis_solve(jV, pV, a_form, m_form, 3, tol=1e-8, method=method)
    assert np.isfinite(vals).all() and (np.diff(vals) >= -1e-9).all() and vals[0] > 0


def test_solve_eigsh_validation():
    jV = fem.Basis(fem.MeshTri(fem.unit_square(n=3)), fem.ElementTri(1, 2))
    pV = pt.Basis(pt.MeshTri(pt.unit_square(n=3), device="cpu"), pt.ElementTri(1, 2))
    for V in (jV, pV):
        with pytest.raises(ValueError, match="eigenpairs from an n=4 system"):
            V.solve_eigsh(a_form, m_form, k=1000)
        with pytest.raises(ValueError, match="unknown precondition"):
            V.solve_eigsh(a_form, m_form, k=2, precondition="nope")
        with pytest.raises(ValueError, match="unknown method"):
            V.solve_eigsh(a_form, m_form, k=2, method="arnoldi")


@pytest.mark.parametrize("method", ["subspace", "lobpcg"])
def test_solve_eigsh_tiny_system_guard_block_clamped(method):
    """k <= n_inner < k + guard: the guard block clamps to the reduced
    dimension (n_inner = 4 on unit_square(n=3)); k=4 is the whole
    spectrum."""
    jV = fem.Basis(fem.MeshTri(fem.unit_square(n=3)), fem.ElementTri(1, 2))
    pV = pt.Basis(pt.MeshTri(pt.unit_square(n=3), device="cpu"), pt.ElementTri(1, 2))
    spectrum = dense_spectrum(reduced(pV, a_form), reduced(pV, m_form))
    for k in (3, 4):
        vals, _ = check_basis_solve(jV, pV, a_form, m_form, k, spectrum, tol=1e-10,
                                    method=method)
        assert np.isfinite(vals).all()
        np.testing.assert_allclose(vals, spectrum[:k], rtol=1e-7)
