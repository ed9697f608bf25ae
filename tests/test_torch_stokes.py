"""PyTorch port, ``compiled_stokes_solver`` against the JAX package in
float64.

The cases of the JAX package's ``tests/test_stokes.py``, each through both
packages' ``compiled_stokes_solver`` on Taylor-Hood P2-P1 with the same
generator meshes and the same load vector (NumPy): on ``unit_square(n=6)``
the nested Schur CG (``method="schur"``), MINRES on the whole saddle system
and the Jacobi A-block preconditioner (tol 1e-10, inner 1e-12), and the
fixed-iteration applies ``inner_iters=25`` and ``6`` on the vector and the
component-decoupled scalar paths; on ``unit_square(n=8)`` the scalar path
(``a_scalar_form``, its aggregate-block M and Jacobi) and the
aggregate-block smoother with the rigid-body-mode (``agg_rbm``) and the
component (``agg_comp``) coarse spaces (tol 1e-9, inner 1e-11).

Held: equal ``outer_iterations``, ``inner_total`` and recovery counts, u
and p to 1e-9; ``inner_iters=6`` finite and within the JAX test's 0.05 of
the tight solution. With the Jacobi A-block preconditioner the inner
solves stop at float64's attainable accuracy, where the recurrence residual
is rounding, so a solve's count moves by 1 with the summation order
(ROADMAP.md, queue C): on the vector path at n=6 the initial f-solve ends
at iteration 41 in the jitted JAX program and at 42 in the port and in the
same JAX code run without jit (its residual at 41: 9.37e-14 in the port
against a threshold of 7.62e-14, 5.25e-14 under XLA's fused sums), so that
case's ``inner_total`` is held equal to the unjitted JAX run and within 1
of the jitted one; on the scalar path at n=8 five of 35 inner solves end
one iteration apart (both JAX runs agree there; the port's assembly and
plain SpMV round differently in the last bit), so its ``inner_total`` is
held within 2 and its recovery count within 1. A second solve with
another right-hand side builds no tensor from host data. The SpMV products
of a solve are the counts ``chip_smoke.py`` holds K2's launches to: sum
over the inner PCG calls of (iterations + 1) for the Schur loop, twice that
on the scalar path (two component columns), iterations + 1 + refreshes + 1
+ the recovery's (iterations + 1) for MINRES. The JAX package's validation
errors, and bf16 preconditioner operands (``operand_dtype``) in the JAX
counts (the recovery solve within 1; ROADMAP.md, queue C).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import compiled_stokes_solver as jax_compiled
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr, compiled, compiled_stokes_solver

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

PI = math.pi


def _m(b):
    return torch if isinstance(b.v, torch.Tensor) else jnp


def div_form(test_p, trial_u):
    div = _m(test_p).einsum("...cc->...", trial_u.v_grad)
    return -(test_p.v[..., 0][..., :, None] * div[..., None, :])


def a_form(b):
    return _m(b).einsum("...icd,...jcd->...ij", b.v_grad, b.v_grad)


def a_scalar(b):
    return b.v_grad @ b.v_grad.swapaxes(-1, -2)


def _vector_load(fx, fy):
    def load(b):
        m = _m(b)
        pts = b.integration_points[..., 0, :]
        f = m.stack([fx(m, pts[..., 0], pts[..., 1]), fy(m, pts[..., 0], pts[..., 1])], -1)
        prod = b.v * f[..., None, :]
        return prod.sum(-1, keepdims=True) if m is jnp else prod.sum(-1, keepdim=True)

    return load


# the loads of the JAX tests: n=6 (compiled vs eager) and n=8 (the scalar path)
LOAD6 = _vector_load(lambda m, x, y: m.sin(PI * x), lambda m, x, y: y**2)
LOAD8 = _vector_load(
    lambda m, x, y: PI * m.sin(PI * x) * m.cos(PI * y),
    lambda m, x, y: -PI * m.cos(PI * x) * m.sin(PI * y) + y**2,
)


def _problem(n, load, dirichlet_components=None):
    jm = fem.MeshTri(fem.unit_square(n=n))
    tm = pt.MeshTri(pt.unit_square(n=n), device="cpu")
    jVu = fem.VectorBasis(jm, fem.ElementTri(2, 4), dirichlet_components=dirichlet_components)
    tVu = pt.VectorBasis(tm, pt.ElementTri(2, 4), dirichlet_components=dirichlet_components)
    jVp, tVp = fem.Basis(jm, fem.ElementTri(1, 4)), pt.Basis(tm, pt.ElementTri(1, 4))
    f = np.array(jVu.integrate_linear_form(load))
    np.testing.assert_allclose(tVu.integrate_linear_form(load).numpy(), f, rtol=0, atol=1e-15)
    return jVu, jVp, tVu, tVp, f


@pytest.fixture(scope="module")
def square6():
    return _problem(6, LOAD6)


@pytest.fixture(scope="module")
def square8():
    return _problem(8, LOAD8)


def _both(problem, **kw):
    """Both packages' compiled solves of ``problem`` with options ``kw``:
    ((u, p, info) of JAX as NumPy and ints, the port's, the port's solve)."""
    jVu, jVp, tVu, tVp, f = problem
    if "a_scalar_form" in kw:
        kw = dict(kw, a_scalar_form=a_scalar)
    u_j, p_j, info_j = jax_compiled(jVu, jVp, a_form, div_form, **kw)(jnp.asarray(f))
    solve = compiled_stokes_solver(tVu, tVp, a_form, div_form, **kw)
    return (np.asarray(u_j), np.asarray(p_j), info_j), solve(torch.as_tensor(f)), solve


def _counts(info):
    total = None if info.inner_total is None else int(info.inner_total)
    return int(info.outer_iterations), total, int(info.inner_info.iterations)


def _assert_parity(jax_run, port_run, tol=1e-9, slack=(0, 0)):
    """Converged, equal outer counts, ``inner_total`` and the recovery's
    count within ``slack``, u and p to ``tol``."""
    (u_j, p_j, info_j), (u, p, info) = jax_run, port_run
    assert bool(info.converged) and bool(info_j.converged)
    assert isinstance(info.outer_iterations, int)
    (outer, total, recovery), (outer_j, total_j, recovery_j) = _counts(info), _counts(info_j)
    assert outer == outer_j and (total is None) == (total_j is None)
    assert abs((total or 0) - (total_j or 0)) <= slack[0] and abs(recovery - recovery_j) <= slack[1]
    np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=tol)
    np.testing.assert_allclose(p.numpy(), p_j, rtol=0, atol=tol)


class _NumpyToTensorCounter:
    """Counts the calls that build a tensor from host data."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name in ("as_tensor", "tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, self._counted(name, getattr(torch, name)))

    def _counted(self, name, real):
        def wrapper(*args, **kwargs):
            self.calls.append(name)
            return real(*args, **kwargs)

        return wrapper


CASES6 = {
    "schur": {},
    "minres": {"method": "minres"},
    "inner_iters=25": {"inner_iters": 25},
    "inner_iters=25 scalar": {"inner_iters": 25, "a_scalar_form": True},
}


@pytest.mark.parametrize("case", sorted(CASES6))
def test_compiled_stokes_matches_jax_n6(square6, monkeypatch, case):
    jax_run, port_run, solve = _both(square6, tol=1e-10, inner_tol=1e-12, **CASES6[case])
    _assert_parity(jax_run, port_run)
    assert (port_run[2].inner_total is None) == (case == "minres")
    # another right-hand side on the built tables: no tensor from host data
    f = torch.as_tensor(square6[4])
    counter = _NumpyToTensorCounter(monkeypatch)
    u2, p2, info2 = solve(2.0 * f)
    assert counter.calls == [] and bool(info2.converged)
    np.testing.assert_allclose(u2.numpy(), 2.0 * jax_run[0], rtol=0, atol=2e-8)


def test_compiled_stokes_jacobi_n6(square6):
    kw = dict(tol=1e-10, inner_tol=1e-12, precondition="jacobi")
    (u_j, p_j, info_j), (u, p, info), _ = _both(square6, **kw)
    jVu, jVp, _, _, f = square6
    with jax.disable_jit():
        _, _, info_eager = jax_compiled(jVu, jVp, a_form, div_form, **kw)(jnp.asarray(f))
    assert bool(info.converged) and bool(info_j.converged)
    assert info.outer_iterations == int(info_j.outer_iterations) == int(info_eager.outer_iterations)
    assert info.inner_total == int(info_eager.inner_total)
    assert abs(info.inner_total - int(info_j.inner_total)) <= 1
    np.testing.assert_allclose(u.numpy(), u_j, rtol=0, atol=1e-9)
    np.testing.assert_allclose(p.numpy(), p_j, rtol=0, atol=1e-9)


@pytest.mark.parametrize("scalar", [False, True])
def test_compiled_stokes_loose_fixed_applies_stay_finite(square6, scalar):
    """``inner_iters=6``: the guards of the outer loop return the best
    iterate, finite and within the JAX test's 0.05 of the tight solution."""
    extra = {"a_scalar_form": True} if scalar else {}
    (u6_j, _, _), (u6, p6, _), _ = _both(
        square6, tol=1e-10, inner_tol=1e-12, inner_iters=6, **extra
    )
    (u_ref, _, _), _, _ = _both(square6, tol=1e-10, inner_tol=1e-12)
    assert bool(torch.isfinite(u6).all()) and bool(torch.isfinite(p6).all())
    assert np.abs(u6.numpy() - u_ref).max() < 0.05
    assert np.abs(u6.numpy() - u6_j).max() < 0.05


CASES8 = {
    "scalar auto": {"a_scalar_form": True},
    "scalar jacobi": {"a_scalar_form": True, "precondition": "jacobi"},
    "agg_rbm": {"precondition": "agg_rbm"},
    "agg_comp": {"precondition": "agg_comp"},
}


@pytest.mark.parametrize("case", sorted(CASES8))
def test_compiled_stokes_matches_jax_n8(square8, case):
    jax_run, port_run, _ = _both(square8, tol=1e-9, inner_tol=1e-11, **CASES8[case])
    # Jacobi's inner solves stop at float64's attainable accuracy (ROADMAP.md,
    # queue C): the JAX package, jitted or not, takes 1,274 inner iterations
    # (recovery 19), the port 1,273 (20)
    _assert_parity(jax_run, port_run, slack=(2, 1) if case == "scalar jacobi" else (0, 0))


def test_compiled_stokes_validation(square8):
    _, _, tVu, tVp, _ = square8
    with pytest.raises(ValueError, match="schur"):
        compiled_stokes_solver(tVu, tVp, a_form, div_form, method="minres", a_scalar_form=a_scalar)
    with pytest.raises(ValueError, match="unknown precondition"):
        compiled_stokes_solver(tVu, tVp, a_form, div_form, precondition="two_level")
    with pytest.raises(ValueError, match="unknown method"):
        compiled_stokes_solver(tVu, tVp, a_form, div_form, method="gmres")
    # bf16 preconditioner operands (the component coarse space): the JAX
    # package's outer and inner counts and answer; the recovery solve ends
    # one iteration apart (JAX 10, port 9: a bf16-rounded residual turns
    # last-bit differences into 2^-8 ones; ROADMAP.md, queue C)
    jVu, jVp, _, _, f = square8
    opts = dict(tol=1e-9, inner_tol=1e-11, precondition="agg_comp")
    u_j, p_j, info_j = jax_compiled(jVu, jVp, a_form, div_form, operand_dtype=jnp.bfloat16,
                                    **opts)(jnp.asarray(f))
    run = compiled_stokes_solver(tVu, tVp, a_form, div_form, operand_dtype=torch.bfloat16,
                                 **opts)(torch.as_tensor(f))
    _assert_parity((np.asarray(u_j), np.asarray(p_j), info_j), run, slack=(0, 1))
    Vu_rx = pt.VectorBasis(tVu.mesh, pt.ElementTri(2, 4), dirichlet_components=(0,))
    with pytest.raises(ValueError, match="components"):
        compiled_stokes_solver(Vu_rx, tVp, a_form, div_form, a_scalar_form=a_scalar)


@pytest.mark.parametrize("case", ["schur", "scalar", "minres"])
def test_spmv_products_per_solve(square6, monkeypatch, case):
    """The K2 count of a solve, from the SpMV products on the CPU."""
    _, _, tVu, tVp, f = square6
    products = []
    plain_vec, plain_cols = compiled.bsr_matvec, bsr.bsr_matvec_cols
    monkeypatch.setattr(compiled, "bsr_matvec", lambda *a: products.append(1) or plain_vec(*a))
    monkeypatch.setattr(
        bsr, "bsr_matvec_cols", lambda st, v, X: products.append(X.shape[1]) or plain_cols(st, v, X)
    )
    kw = {"scalar": {"a_scalar_form": a_scalar}, "minres": {"method": "minres"}}.get(case, {})
    u, p, info = compiled_stokes_solver(tVu, tVp, a_form, div_form, tol=1e-8, inner_tol=1e-10,
                                        **kw)(torch.as_tensor(f))
    assert bool(info.converged)
    if case == "minres":
        its, restart = info.outer_iterations, 50
        expected = its + 1 + its // restart + 1 + info.inner_info.iterations + 1
        assert its > restart
    else:
        # sum over the inner PCG calls (f-solve, one Schur apply per outer
        # iteration and the initial one, the recovery) of iterations + 1
        expected = (info.inner_total + info.outer_iterations + 3) * (2 if case == "scalar" else 1)
    assert sum(products) == expected
