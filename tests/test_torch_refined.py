"""PyTorch port, the mixed-precision refined solver against the JAX package
in float64.

The cases of the JAX package's ``tests/test_refine.py``, each through both
packages' ``compiled_refined_solver`` on the same mesh: the sine Poisson
problem on ``rectangle(24)`` P1 (``refine`` 0 and 2, the aggregate-block M
as the JAX test has it; Jacobi on the unit load), the explicit-rhs vector case on ``rectangle(10)`` (the
rigid-body-mode M), the basis hook on ``rectangle(8)`` and the rejection of
a float32 basis, with the JAX package's other errors.

Held: the refined solutions within 1e-10 relative (the float32-only
solutions of ``refine=0`` within 1e-5, both solved to 1e-6); the final true residuals of both
below 1e-11; every float32-only stage of both above 1e-8 (the float32 floor,
as the JAX test asserts) and within 10x of each other; the inner PCG counts
of each stage within 1. The inner stages run in float32 in both packages,
and XLA and torch sum in different orders, so a stage may stop one
iteration apart; the float64 quantities are held tightly. The right-hand
side of a refinement stage is the float64 residual of the float32 stage
before it, which is float32 rounding: it differs between the packages by
O(1) relative (1.59 for the first Jacobi pass here), so those stages solve
different systems. With Jacobi (55-64 iterations a stage) their counts
are held within 2 (measured 57/55 and 64/62; on the same float32
right-hand side both packages' PCGs take 55). Jacobi's sine-load case is
not used: its rhs is nearly an eigenvector, float64 CG reaches 4e-14 in 2
iterations, and the float32 recurrence residual of both packages hovers at
0.93-1.8e-6 from the 3rd to the 16th iteration, so where it first meets
the 1e-6 tolerance is roundoff (JAX 16, the port 7). The port's SpMV
calls, counted through a wrapper of ``refine.bsr_matvec``: sum(iterations
+ 1) in float32 (one for the start of each PCG) and 1 + refine in float64,
the count ``chip_smoke.py`` holds K2's launches to on the card.
``RefineInfo`` is ``(tuple of int, float64 tensor, 0-dim bool tensor)``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.mesh.dfn import build_fracture_network as jax_network
from pytorch_fem_solver_tpu.ops import compiled_refined_solver as jax_refined
from pytorch_fem_solver_tpu_torch import bench, config
from pytorch_fem_solver_tpu_torch.ops import RefineInfo, compiled_refined_solver, refine

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

PI = math.pi
F1 = [[-1, 0, 0], [1, 0, 0], [1, 1, 0], [-1, 1, 0]]
F2 = [[0, 0, -1], [0, 0, 1], [0, 1, 1], [0, 1, -1]]


def _m(b):
    return torch if isinstance(b.v, torch.Tensor) else jnp


def stiffness(b):
    return b.v_grad @ b.v_grad.swapaxes(-1, -2)


def sine_load(b):
    m = _m(b)
    x, y = b.integration_points[..., 0:1], b.integration_points[..., 1:2]
    return 2 * PI**2 * m.sin(PI * x) * m.sin(PI * y) * b.v


def vector_stiffness(b):
    return _m(b).einsum("...icd,...jcd->...ij", b.v_grad, b.v_grad)


def vector_load(b):
    return b.v.sum(-1, keepdims=True) if _m(b) is jnp else b.v.sum(-1, keepdim=True)


def _poisson(n):
    return (
        fem.Basis(fem.MeshTri(fem.rectangle(n, n)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.rectangle(n, n), device="cpu"), pt.ElementTri(1, 2)),
    )


def _rel(ours, ref) -> float:
    ref = np.asarray(ref)
    return float(np.abs(ours.numpy() - ref).max() / np.abs(ref).max())


class _CountedMatvec:
    """Counts ``refine.bsr_matvec`` calls by the dtype of ``x``."""

    def __init__(self, monkeypatch):
        self.counts = {torch.float32: 0, torch.float64: 0}
        plain = refine.bsr_matvec

        def counted(st, values, x):
            self.counts[x.dtype] += 1
            return plain(st, values, x)

        monkeypatch.setattr(refine, "bsr_matvec", counted)


def check_parity(u, info, u_ref, info_ref, refine_passes, pass_gap=1):
    """The port's refined solve against the JAX package's; the inner
    counts of the refinement passes within ``pass_gap``."""
    assert isinstance(info, RefineInfo)
    assert isinstance(info.inner_iterations, tuple)
    assert all(isinstance(k, int) for k in info.inner_iterations)
    assert info.residuals.dtype == torch.float64 and info.residuals.shape == (1 + refine_passes,)
    assert info.converged.dtype == torch.bool and info.converged.dim() == 0
    assert u.dtype == torch.float64
    # refined: float64 grade; refine=0: two float32 solves to 1e-6, each
    # about 1e-6 from the float64 solution
    assert _rel(u, u_ref) <= (1e-10 if refine_passes else 1e-5)
    res, res_ref = info.residuals.numpy(), np.asarray(info_ref.residuals)
    assert res[0] > 1e-8 and res_ref[0] > 1e-8  # the float32-only stage: the float32 floor
    assert 0.1 <= res[0] / res_ref[0] <= 10.0
    if refine_passes:
        assert res[-1] < 1e-11 and res_ref[-1] < 1e-11
    counts, counts_ref = info.inner_iterations, np.asarray(info_ref.inner_iterations)
    assert len(counts) == len(counts_ref) and abs(counts[0] - counts_ref[0]) <= 1
    np.testing.assert_allclose(counts[1:], counts_ref[1:], atol=pass_gap)
    assert bool(info.converged) is bool(info_ref.converged)


def unit_load(b):
    return b.v


@pytest.mark.parametrize("precondition, load, pass_gap", [
    ("auto", sine_load, 1),
    ("jacobi", unit_load, 2),
])
def test_refined_solve_reaches_f64_grade(monkeypatch, precondition, load, pass_gap):
    jV, pV = _poisson(24)
    u_dense = pV.solve(
        pV.integrate_bilinear_form(stiffness), pV.solution_tensor(),
        pV.integrate_linear_form(load),
    )
    errs = {}
    for passes in (0, 2):
        u_ref, info_ref = jax_refined(jV, stiffness, load, refine=passes, tol32=1e-6,
                                      precondition=precondition)()
        spmv = _CountedMatvec(monkeypatch)
        u, info = compiled_refined_solver(pV, stiffness, load, refine=passes, tol32=1e-6,
                                          precondition=precondition)()
        check_parity(u, info, u_ref, info_ref, passes, pass_gap)
        assert spmv.counts == {torch.float32: sum(k + 1 for k in info.inner_iterations),
                               torch.float64: 1 + passes}
        errs[passes] = float((u - u_dense).abs().max() / u_dense.abs().max())
        monkeypatch.undo()
    res = info.residuals.numpy()
    assert res[-1] < res[0]
    assert errs[2] < 1e-9 and bool(info.converged)
    assert errs[0] > 10 * errs[2]  # refinement bought real digits


def test_refined_solve_explicit_rhs_and_vector_basis(monkeypatch):
    jV = fem.VectorBasis(fem.MeshTri(fem.rectangle(10, 10)), fem.ElementTri(1, 2))
    pV = pt.VectorBasis(pt.MeshTri(pt.rectangle(10, 10), device="cpu"), pt.ElementTri(1, 2))
    b_ref = jV.integrate_linear_form(vector_load)
    b = pV.integrate_linear_form(vector_load)
    np.testing.assert_allclose(b.numpy(), np.asarray(b_ref), rtol=0, atol=1e-15)
    u_dense = pV.solve(pV.integrate_bilinear_form(vector_stiffness), pV.solution_tensor(), b)

    u_ref, info_ref = jax_refined(jV, vector_stiffness, refine=2, tol32=1e-5)(b_ref)
    solve = compiled_refined_solver(pV, vector_stiffness, refine=2, tol32=1e-5)
    spmv = _CountedMatvec(monkeypatch)
    u, info = solve(b)
    check_parity(u, info, u_ref, info_ref, 2)
    assert spmv.counts[torch.float64] == 3
    assert float((u - u_dense).abs().max() / u_dense.abs().max()) < 1e-9
    # the rigid-body-mode W cached on the float64 basis stays float64
    (ast,) = pV._affine_two_level_structures.values()
    assert ast.W.dtype == torch.float64 and ast.Wb.dtype == torch.float64

    with pytest.raises(ValueError, match="f64 right-hand side"):
        jax_refined(jV, vector_stiffness, refine=2, tol32=1e-5)(b_ref.astype(jnp.float32))
    with pytest.raises(ValueError, match="f64 right-hand side"):
        solve(b.to(torch.float32))
    # the bench workload of chip_smoke.py is this case at a given size
    r = bench.refined_elasticity(10, device="cpu")
    check_parity(r.u, r.info, u_ref, info_ref, 2)


def test_bench_refined_dfn():
    """``bench.refined_dfn`` (``tools/exp_refine_tpu.py``'s problem: the
    network's stiffness and unit load) on the h=0.25 two-fracture network
    against the JAX package's refined solve of the same problem."""
    jV = fem.FractureNetworkBasis(jax_network([F1, F2], h=0.25), fem.ElementTri(1, 2))
    mesh = pt.build_fracture_network([F1, F2], h=0.25, device="cpu", dtype=torch.float64)
    for passes in (0, 2):
        u_ref, info_ref = jax_refined(jV, stiffness, unit_load, refine=passes)()
        r = bench.refined_dfn(mesh, refine=passes)
        check_parity(r.u, r.info, u_ref, info_ref, passes)
        u, info = r.solve()  # a second solve on the built tables: the same bits
        assert torch.equal(u, r.u) and info.inner_iterations == r.info.inner_iterations


def test_basis_compiled_refined_hook():
    jV, pV = _poisson(8)
    u_dense = pV.solve(
        pV.integrate_bilinear_form(stiffness), pV.solution_tensor(),
        pV.integrate_linear_form(sine_load),
    )
    u_ref, info_ref = jV.compiled_refined(stiffness, sine_load, refine=2)()
    u, info = pV.compiled_refined(stiffness, sine_load, refine=2)()
    assert float((u - u_dense).abs().max()) < 1e-12
    assert _rel(u, u_ref) <= 1e-10
    np.testing.assert_allclose(info.inner_iterations, np.asarray(info_ref.inner_iterations), atol=1)
    assert bool(info.converged) is bool(info_ref.converged) is True


def test_refined_solver_rejects_f32_basis():
    jV, _ = _poisson(4)
    f32_basis = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.float64 else x,
        jV,
    )
    with pytest.raises(ValueError, match="x64 basis"):
        jax_refined(f32_basis, stiffness, sine_load)
    pV32 = pt.Basis(pt.MeshTri(pt.rectangle(4, 4), device="cpu", dtype=torch.float32),
                    pt.ElementTri(1, 2))
    with pytest.raises(ValueError, match="float64 basis"):
        compiled_refined_solver(pV32, stiffness, sine_load)


@pytest.mark.parametrize("kwargs, match", [
    ({"precondition": "two_level"}, "unknown precondition"),
    ({"refine": -1}, "refine must be >= 0"),
])
def test_refined_solver_argument_errors(kwargs, match):
    jV, pV = _poisson(4)
    with pytest.raises(ValueError, match=match):
        jax_refined(jV, stiffness, sine_load, **kwargs)
    with pytest.raises(ValueError, match=match):
        compiled_refined_solver(pV, stiffness, sine_load, **kwargs)
