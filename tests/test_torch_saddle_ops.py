"""PyTorch port, the saddle-point building blocks against the JAX package in
float64: the mixed bilinear forms, the multi-column BSR helpers, the
multi-column PCG, MINRES, and the eager Schur-complement ``stokes_solver``.

Inputs are the JAX Stokes tests' (``tests/test_stokes.py``): the mixed forms
on ``unit_square(n=3)`` (P1-P1 and Taylor-Hood P2-P1, ``-q div u``), the BSR
helpers and ``pcg_cols`` on ``unit_square(n=10)`` P1 with a second column
scaled by 1e3 (so the two columns converge at different iterations), MINRES
on the dense Taylor-Hood saddle operator of ``unit_square(n=6)`` with the
block-diagonal preconditioner of the compiled MINRES (Jacobi on A, the
mean-projected lumped pressure mass inverse), and ``stokes_solver`` on
``unit_square(n=6)`` and ``MeshTet(unit_cube(3))``. Both packages build
their bases from the same generator output; right-hand sides and start
blocks cross as the same NumPy arrays.

Held: the mixed forms to 1e-13 and their two validation errors with the
JAX words; ``bsr_matvec_cols`` to 1e-12 (float64 values on a float32
block to 1e-6 of max |Y|, the JAX package's mixed-dtype sums),
``bsr_reduce_cols`` and
``bsr_expand_cols`` bitwise; ``pcg_cols`` with the same shared iteration
count, X to 1e-10, and each column equal to a single-column ``pcg``; the
per-column preconditioner of the scalar Stokes path bitwise the M of each
column alone;
MINRES with equal iteration counts without restarts and with
``restart=50``, solutions to 1e-9, and ``restart=0`` refused;
``stokes_solver`` with equal outer counts, u to 1e-9 and p to 1e-7, the
discrete divergence and the pressure's lumped-mass mean at roundoff.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import bsr as jbsr
from pytorch_fem_solver_tpu.ops import solvers as jsolvers
from pytorch_fem_solver_tpu.ops import stokes_solver as jax_stokes
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr, solvers, stokes_solver
from pytorch_fem_solver_tpu_torch.ops.saddle import lumped_mass

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


def _m(b):
    return torch if isinstance(b.v, torch.Tensor) else jnp


def div_form(test_p, trial_u):
    div = _m(test_p).einsum("...cc->...", trial_u.v_grad)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def a_form(b):
    return _m(b).einsum("...icd,...jcd->...ij", b.v_grad, b.v_grad)


def stiffness(b):
    return b.v_grad @ b.v_grad.swapaxes(-1, -2)


def curl_load(b):
    m = _m(b)
    pts = b.integration_points[..., 0, :]
    x, y = pts[..., 0], pts[..., 1]
    f = m.stack([m.sin(math.pi * x), y**2], -1)
    return (b.v * f[..., None, :]).sum(-1, keepdims=True) if m is jnp else (
        (b.v * f[..., None, :]).sum(-1, keepdim=True))


def _pair(mesh_fn, u_elem, p_elem):
    """(JAX Vu, Vp), (port Vu, Vp) on one mesh each, from the same generator."""
    jm = fem.MeshTri(mesh_fn(fem))
    tm = pt.MeshTri(mesh_fn(pt), device="cpu")
    return (
        (fem.VectorBasis(jm, fem.ElementTri(*u_elem)), fem.Basis(jm, fem.ElementTri(*p_elem))),
        (pt.VectorBasis(tm, pt.ElementTri(*u_elem)), pt.Basis(tm, pt.ElementTri(*p_elem))),
    )


def _square(n):
    return lambda pkg: pkg.unit_square(n=n)


@pytest.mark.parametrize("u_elem, p_elem", [((1, 2), (1, 2)), ((2, 4), (1, 4))])
def test_mixed_forms_match_jax(u_elem, p_elem):
    (jVu, jVp), (tVu, tVp) = _pair(_square(3), u_elem, p_elem)
    local = tVp.integrate_mixed_bilinear_form_local(tVu, div_form)
    np.testing.assert_allclose(
        local.numpy(), np.asarray(jVp.integrate_mixed_bilinear_form_local(jVu, div_form)),
        rtol=0, atol=1e-13,
    )
    B = tVp.integrate_mixed_bilinear_form(tVu, div_form)
    assert B.shape == (tVp.n_dofs, tVu.n_dofs)
    np.testing.assert_allclose(
        B.numpy(), np.asarray(jVp.integrate_mixed_bilinear_form(jVu, div_form)),
        rtol=0, atol=1e-13,
    )


def test_mixed_form_validation_matches_jax():
    mesh = pt.MeshTri(pt.unit_square(n=2), device="cpu")
    mesh2 = pt.MeshTri(pt.unit_square(n=3), device="cpu")
    Vp = pt.Basis(mesh, pt.ElementTri(1, 2))
    with pytest.raises(ValueError, match="same mesh"):
        Vp.integrate_mixed_bilinear_form(pt.VectorBasis(mesh2, pt.ElementTri(1, 2)), div_form)
    with pytest.raises(ValueError, match="integration orders"):
        Vp.integrate_mixed_bilinear_form(pt.VectorBasis(mesh, pt.ElementTri(1, 4)), div_form)
    with pytest.raises(ValueError, match="integration orders"):
        Vp.integrate_mixed_bilinear_form_local(pt.VectorBasis(mesh, pt.ElementTri(1, 4)), div_form)


@pytest.fixture(scope="module")
def poisson10():
    """The n=10 P1 Laplacian in both packages, its two right-hand sides
    (the unit load and a seeded one scaled by 1e3) and a seeded (n_dofs, 2)
    block, all as the same NumPy arrays."""
    jV = fem.Basis(fem.MeshTri(fem.unit_square(n=10)), fem.ElementTri(1, 3))
    tV = pt.Basis(pt.MeshTri(pt.unit_square(n=10), device="cpu"), pt.ElementTri(1, 3))
    jst = jbsr.get_bsr_structure(jV, max_b=8)
    tst = bsr.get_bsr_structure(tV, max_b=8)
    jvals = jbsr.bsr_values_from_local_symmetric(jst, jV.integrate_bilinear_form_local(stiffness))
    tvals = bsr.bsr_values_from_local_symmetric(tst, tV.integrate_bilinear_form_local(stiffness))
    rng = np.random.default_rng(0)
    full = np.stack([np.asarray(jV.integrate_linear_form(lambda b: b.v)[:, 0]),
                     rng.normal(size=(jV.n_dofs,)) * 1e3], axis=1)
    block = rng.normal(size=(jV.n_dofs, 2))
    return jst, tst, jvals, tvals, full, block, jV.n_dofs


def test_bsr_cols_helpers_match_jax(poisson10):
    jst, tst, jvals, tvals, full, block, n_dofs = poisson10
    red = bsr.bsr_reduce_cols(tst, torch.as_tensor(block))
    red_j = jbsr.bsr_reduce_cols(jst, jnp.asarray(block))
    np.testing.assert_array_equal(red.numpy(), np.asarray(red_j))
    np.testing.assert_array_equal(
        red[:, 1].numpy(), bsr.bsr_reduce(tst, torch.as_tensor(block[:, 1])).numpy()
    )
    np.testing.assert_array_equal(
        bsr.bsr_expand_cols(tst, red, n_dofs).numpy(),
        np.asarray(jbsr.bsr_expand_cols(jst, red_j, n_dofs)),
    )
    Y = bsr.bsr_matvec_cols(tst, tvals, red)
    Y_jax = np.asarray(jbsr.bsr_matvec_cols(jst, jvals, red_j))
    atol = 1e-12 * np.abs(Y_jax).max()
    np.testing.assert_allclose(Y.numpy(), Y_jax, rtol=0, atol=atol)
    for c in range(2):
        y = bsr.bsr_matvec(tst, tvals, red[:, c].contiguous())
        np.testing.assert_allclose(Y[:, c].numpy(), y.numpy(), rtol=0, atol=atol)
    # float64 values on a float32 block: x rounded to the values' dtype,
    # sums in float32, as the JAX package computes it
    Y32 = bsr.bsr_matvec_cols(tst, tvals, red.float())
    Y32_jax = np.asarray(jbsr.bsr_matvec_cols(jst, jvals, red_j.astype(jnp.float32)))
    assert Y32.dtype == torch.float32 and Y32_jax.dtype == np.float32
    np.testing.assert_allclose(Y32.numpy(), Y32_jax, rtol=0, atol=1e-6 * np.abs(Y32_jax).max())


def test_pcg_cols_matches_jax(poisson10):
    jst, tst, jvals, tvals, full, _, _ = poisson10
    B_t = bsr.bsr_reduce_cols(tst, torch.as_tensor(full))
    B_j = jbsr.bsr_reduce_cols(jst, jnp.asarray(full))
    X, info = solvers.pcg_cols(lambda Z: bsr.bsr_matvec_cols(tst, tvals, Z), B_t, tol=1e-10)
    X_j, info_j = jsolvers.pcg_cols(lambda Z: jbsr.bsr_matvec_cols(jst, jvals, Z), B_j, tol=1e-10)
    assert isinstance(info.iterations, int) and info.iterations == int(info_j.iterations)
    assert bool(info.converged) and bool(info_j.converged)
    assert info.residual_norm.shape == (2,)
    scale = np.abs(np.asarray(X_j)).max()
    np.testing.assert_allclose(X.numpy(), np.asarray(X_j), rtol=0, atol=1e-10 * scale)
    # each column is its own CG: frozen once converged, equal to a single pcg
    counts = []
    for c in range(2):
        x, one = solvers.pcg(
            lambda v: bsr.bsr_matvec(tst, tvals, v), B_t[:, c].contiguous(), tol=1e-10
        )
        counts.append(one.iterations)
        np.testing.assert_allclose(X[:, c].numpy(), x.numpy(), rtol=0,
                                   atol=1e-12 * float(x.abs().max()))
    assert counts[0] != counts[1] and info.iterations == max(counts)


def test_preconditioner_of_the_columns_is_per_column_bitwise(poisson10):
    """The scalar Stokes path applies the aggregate-block M column by column
    (the JAX ``vmap``): bitwise the M of each column alone."""
    from pytorch_fem_solver_tpu_torch.ops.eigen import _block
    from pytorch_fem_solver_tpu_torch.ops.precondition import agg_block_two_level_from_values

    _, tst, _, tvals, _, _, _ = poisson10
    precond = agg_block_two_level_from_values(tst, tvals, bsr.bsr_diagonal(tst, tvals))
    R = torch.as_tensor(np.random.default_rng(3).standard_normal((tst.n_pad, 2)))
    Z = _block(precond)(R)
    for c in range(2):
        assert torch.equal(Z[:, c], precond(R[:, c].clone()))


def _saddle6():
    """The dense Taylor-Hood saddle operator of ``unit_square(n=6)`` (the
    Dirichlet-reduced A, B and B^T), the reduced load and the lumped mass,
    as NumPy arrays from the JAX package."""
    mesh = fem.MeshTri(fem.unit_square(n=6))
    Vu = fem.VectorBasis(mesh, fem.ElementTri(2, 4))
    Vp = fem.Basis(mesh, fem.ElementTri(1, 4))
    inner = np.asarray(Vu._basis_parameters["inner_dofs"])
    A = np.asarray(Vu.reduce(Vu.integrate_bilinear_form(a_form)))
    B = np.asarray(Vp.integrate_mixed_bilinear_form(Vu, div_form))[:, inner]
    f = np.asarray(Vu.reduce(Vu.integrate_linear_form(curl_load)))[:, 0]
    local_m = Vp.integrate_bilinear_form_local(lambda b: b.v @ jnp.matrix_transpose(b.v))
    mp = np.array(Vp._assemble_linear_from_local(local_m.sum(-1, keepdims=True)))[:, 0]
    n_u, n_p = A.shape[0], B.shape[0]
    K = np.zeros((n_u + n_p, n_u + n_p))
    K[:n_u, :n_u], K[:n_u, n_u:], K[n_u:, :n_u] = A, B.T, B
    return K, np.concatenate([f, np.zeros(n_p)]), 1.0 / np.diag(A), mp, n_u


@pytest.mark.parametrize("restart", [None, 50])
def test_minres_matches_jax_on_the_saddle_operator(restart):
    K, rhs, inv_diag, mp, n_u = _saddle6()

    def run(xp, minres):
        Kx, rhs_x, d, m = (xp.asarray(a) for a in (K, rhs, inv_diag, mp))

        def precond(r):
            rp = r[n_u:]
            return xp.concatenate([d * r[:n_u], rp / m - rp.sum() / m.sum()])

        return minres(lambda v: Kx @ v, rhs_x, precond=precond, tol=1e-10, restart=restart)

    x, info = run(torch, solvers.minres)
    x_j, info_j = run(jnp, jsolvers.minres)
    assert isinstance(info.iterations, int)
    assert info.iterations == int(info_j.iterations) and info.iterations > 50
    assert bool(info.converged) and bool(info_j.converged)
    x_j = np.asarray(x_j)
    np.testing.assert_allclose(x.numpy(), x_j, rtol=0, atol=1e-9 * np.abs(x_j).max())
    # the momentum rows hold (the pressure is determined up to its constant)
    np.testing.assert_allclose(
        (K @ x.numpy())[:n_u], rhs[:n_u], rtol=0, atol=1e-8 * np.abs(rhs).max()
    )


def test_minres_restart_validation():
    b = torch.ones(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="restart"):
        solvers.minres(lambda x: 2.0 * x, b, restart=0)
    for r in (None, 2):
        x, info = solvers.minres(lambda x: 2.0 * x, b, tol=1e-12, restart=r)
        np.testing.assert_allclose(x.numpy(), 0.5 * b.numpy(), atol=1e-10)


def _check_stokes_solution(Vu, Vp, u, p, div_tol):
    """The discrete divergence and the pressure's lumped-mass mean."""
    local_b = Vp.integrate_mixed_bilinear_form_local(Vu, div_form)
    u_cells = u[:, 0][Vu._global_dofs4elements.long()][..., None]
    bu = Vp._assemble_linear_from_local(local_b @ u_cells)
    assert float(bu.abs().max()) <= div_tol * max(float(u.abs().max()), 1e-30) + 1e-10
    mp = lumped_mass(Vp)
    assert abs(float((mp * p).sum())) <= 1e-13 * float((mp * p.abs()).sum())


def test_stokes_solver_matches_jax_2d():
    (jVu, jVp), (tVu, tVp) = _pair(_square(6), (2, 4), (1, 4))
    f = np.array(jVu.integrate_linear_form(curl_load))
    u_j, p_j, info_j = jax_stokes(jVu, jVp, a_form, div_form, tol=1e-10, inner_tol=1e-12)(jnp.asarray(f))
    u, p, info = stokes_solver(tVu, tVp, a_form, div_form, tol=1e-10, inner_tol=1e-12)(torch.as_tensor(f))
    assert bool(info.converged) and bool(info_j.converged)
    assert isinstance(info.outer_iterations, int)
    assert info.outer_iterations == int(info_j.outer_iterations)
    assert info.inner_info.iterations == int(info_j.inner_info.iterations)
    assert info.inner_total is None
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-7)
    _check_stokes_solution(tVu, tVp, u, p, 1e-9)


def test_stokes_solver_matches_jax_3d():
    from pytorch_fem_solver_tpu.element import ElementTet as JTet
    from pytorch_fem_solver_tpu.mesh import MeshTet as JMeshTet

    jm, tm = JMeshTet(fem.unit_cube(3)), pt.MeshTet(pt.unit_cube(3), device="cpu")
    jVu, jVp = fem.VectorBasis(jm, JTet(2, 3)), fem.Basis(jm, JTet(1, 3))
    tVu, tVp = pt.VectorBasis(tm, pt.ElementTet(2, 3)), pt.Basis(tm, pt.ElementTet(1, 3))

    def load(b):
        # a constant body force (enclosed forcing), the JAX test's
        if _m(b) is jnp:
            return (jnp.asarray([1.0, 0.0, -0.5]) * b.v).sum(-1, keepdims=True)
        return (torch.tensor([1.0, 0.0, -0.5], dtype=b.v.dtype) * b.v).sum(-1, keepdim=True)

    f = np.array(jVu.integrate_linear_form(load))
    u_j, p_j, info_j = jax_stokes(jVu, jVp, a_form, div_form, tol=1e-8, inner_tol=1e-10)(jnp.asarray(f))
    u, p, info = stokes_solver(tVu, tVp, a_form, div_form, tol=1e-8, inner_tol=1e-10)(torch.as_tensor(f))
    assert bool(info.converged) and bool(info_j.converged)
    assert info.outer_iterations == int(info_j.outer_iterations)
    np.testing.assert_allclose(u.numpy(), np.asarray(u_j), rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.numpy(), np.asarray(p_j), rtol=0, atol=1e-7)
    _check_stokes_solution(tVu, tVp, u, p, 1e-7)
