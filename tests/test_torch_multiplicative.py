"""PyTorch port, the multiplicative V(1,1) cycles (``ops/precondition.py``:
``_smoother_scale``, ``mult_two_level_from_values``,
``mult_three_level_from_values``) and ``solve_iterative(precondition=
"mult_two_level")`` against the JAX package in float64.

On the h=0.25 DFN and ``unit_square(n=16)``, with the same assembled
values: the power-iteration scale within 1e-12, the apply on 3 seeded
vectors within 1e-12 for ``omega="auto"`` and a float, with
``inner_dtype=torch.bfloat16`` (the bf16 inner SpMVs, 1e-12 too: both
packages round x to bf16 and sum exact products in float64) and
``operand_dtype``; PCG with each cycle in the JAX iteration count,
solutions within 1e-10; the SpMVs each cycle makes (12 at setup for
``"auto"``, 2 per apply), counted on the CPU where the card counts K2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops import solvers as jsol
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import precondition as pp
from pytorch_fem_solver_tpu_torch.ops import solvers as psol

from test_torch_three_level import REL, SOL, bsr_system, rel, stiffness, vectors

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


@pytest.fixture(scope="module", params=["dfn", "square"])
def system(request):
    return bsr_system(request.param)


def _pair(s, which, **kw):
    """Both packages' cycle of ``which`` ("two" or "three") on ``s``; a
    dtype is named "bf16" in ``kw``."""
    jkw = {k: (jnp.bfloat16 if v == "bf16" else v) for k, v in kw.items()}
    pkw = {k: (torch.bfloat16 if v == "bf16" else v) for k, v in kw.items()}
    if which == "two":
        return (
            jp.mult_two_level_from_values(s["jst"], s["jvals"], s["jdiag"], **jkw),
            pp.mult_two_level_from_values(s["pst"], s["pvals"], s["pdiag"], **pkw),
        )
    return (
        jp.mult_three_level_from_values(
            jp.get_three_level_structure(s["jV"], s["jst"]), s["jst"], s["jvals"], s["jdiag"],
            **jkw,
        ),
        pp.mult_three_level_from_values(
            pp.get_three_level_structure(s["pV"], s["pst"]), s["pst"], s["pvals"], s["pdiag"],
            **pkw,
        ),
    )


def test_smoother_scale_matches_jax(system):
    s = system
    jbase = jp.block_two_level_from_values(s["jst"], s["jvals"], s["jdiag"])
    pbase = pp.block_two_level_from_values(s["pst"], s["pvals"], s["pdiag"])
    ref = jp._smoother_scale(
        lambda r: jp._apply_fine(jbase.blk_inv, None, r),
        lambda v: jb.bsr_matvec(s["jst"], s["jvals"], v), s["jst"].n_pad, jnp.float64,
    )
    ours = pp._smoother_scale(
        lambda r: pp._apply_fine(pbase.blk_inv, None, r),
        lambda v: pb.bsr_matvec(s["pst"], s["pvals"], v), s["pst"].n_pad, torch.float64,
    )
    assert ours.shape == () and ours.dtype == torch.float64
    assert abs(float(ours) - float(ref)) <= REL * abs(float(ref))
    assert 0.3 < float(ours) < 1.0  # 1/rho(S A) of block-Jacobi lies below 1


@pytest.mark.parametrize("which,kw", [
    ("two", {}),
    ("two", {"omega": 0.8}),
    ("two", {"g": 64}),
    ("two", {"inner_dtype": "bf16"}),
    ("two", {"operand_dtype": "bf16"}),
    ("three", {}),
    ("three", {"omega": 0.8}),
    ("three", {"operand_dtype": "bf16"}),
], ids=["two-auto", "two-0.8", "two-g64", "two-inner-bf16", "two-operands-bf16",
        "three-auto", "three-0.8", "three-operands-bf16"])
def test_apply_matches_jax(system, which, kw):
    s = system
    ref, ours = _pair(s, which, **kw)
    for w in vectors(s["pst"].n_pad):
        assert rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL


@pytest.mark.parametrize("which", ["two", "three"])
def test_pcg_iterations_equal_jax(system, which):
    s = system
    ref_m, ours_m = _pair(s, which)
    x_ref, info_ref = jsol.pcg(lambda v: jb.bsr_matvec(s["jst"], s["jvals"], v),
                               jnp.asarray(s["b"]), precond=ref_m, tol=1e-10)
    x, info = psol.pcg(lambda v: pb.bsr_matvec(s["pst"], s["pvals"], v),
                       torch.from_numpy(s["b"]), precond=ours_m, tol=1e-10)
    assert info.iterations == int(info_ref.iterations) > 3
    assert bool(info.converged)
    assert rel(x, x_ref) <= SOL


def test_solve_iterative_mult_two_level_matches_jax(system):
    s = system
    jV, pV = s["jV"], s["pV"]
    jb_ = jV.integrate_linear_form(lambda v: v.v)
    pb_ = pV.integrate_linear_form(lambda v: v.v)
    u_ref, info_ref = jV.solve_iterative(
        jV.integrate_bilinear_form_local(stiffness), jb_, precondition="mult_two_level",
        return_info=True,
    )
    u, info = pV.solve_iterative(
        pV.integrate_bilinear_form_local(stiffness), pb_, precondition="mult_two_level",
        return_info=True,
    )
    assert info.iterations == int(info_ref.iterations)
    # fewer iterations than the additive two-level M, as the JAX docstring says
    _, info_add = pV.solve_iterative(
        pV.integrate_bilinear_form_local(stiffness), pb_, precondition="two_level",
        return_info=True,
    )
    assert info.iterations < info_add.iterations
    assert rel(u, u_ref) <= SOL


@pytest.mark.parametrize("which,omega,setup", [
    ("two", "auto", 12), ("two", 0.8, 0), ("three", "auto", 12), ("three", 0.8, 0),
])
def test_spmv_count_per_setup_and_apply(system, monkeypatch, which, omega, setup):
    """The SpMVs a cycle makes: what the card's K2 count must equal."""
    s = system
    calls = []
    plain = pp.bsr_matvec

    def counted(st, values, x):
        calls.append(values[0].dtype)
        return plain(st, values, x)

    monkeypatch.setattr(pp, "bsr_matvec", counted)
    m = _pair(s, which, omega=omega)[1] if which == "three" else pp.mult_two_level_from_values(
        s["pst"], s["pvals"], s["pdiag"], omega=omega)
    assert len(calls) == setup
    m(torch.from_numpy(vectors(s["pst"].n_pad, 1)[0]))
    assert len(calls) == setup + 2
    calls.clear()
    pp.mult_two_level_from_values(s["pst"], s["pvals"], s["pdiag"],
                                  inner_dtype=torch.bfloat16)(torch.ones(s["pst"].n_pad))
    assert calls == [torch.bfloat16] * 14


def _jax_bench(jV, precond, operand_dtype, tol):
    """The repo-root ``bench.py``'s BENCH_PRECOND branches on the JAX
    package, on the values and load of K1's rows (``_jax_bench_path``'s
    assembly): (x, iterations)."""
    from pytorch_fem_solver_tpu.ops import pallas_kernels as jk
    from pytorch_fem_solver_tpu_torch import bench

    st = jb.get_bsr_structure(jV, max_b=8, want_entry_slot=False)
    T = jV.mesh.n_cells
    out = jk._p1_xla_3d(jk.coords_to_soa_3d(jV.mesh["cells", "coordinates_3d"]))[:, :T]
    iu, ju = np.triu_indices(3)
    e6 = out[np.asarray(bench.SYM_ROWS)] * jnp.asarray(np.where(iu == ju, 0.5, 1.0))[:, None]
    slots_T = np.asarray(st.entry_slot_sym).reshape(T, 6).T.reshape(-1)
    values = jb.bsr_complete_symmetric(
        st, jnp.zeros(st.n_values).at[slots_T].add(e6.reshape(-1), mode="drop"))
    dofs_pad_T = jb.inverse_inner_perm(st, jV.n_dofs)[
        np.asarray(jV._global_dofs4elements).T.reshape(-1)]
    b_pad = jnp.zeros(st.n_pad).at[dofs_pad_T].add(out[9:12].reshape(-1), mode="drop")
    diag = jb.bsr_diagonal(st, values)
    od = operand_dtype
    m = {
        "aggblock": lambda: jp.agg_block_two_level_from_values(st, values, diag, operand_dtype=od),
        "two_level": lambda: jp.block_two_level_from_values(st, values, diag, operand_dtype=od),
        "mult": lambda: jp.mult_two_level_from_values(st, values, diag, operand_dtype=od),
        "affine": lambda: jp.affine_two_level_from_values(
            jp.get_affine_two_level_structure(jV, st), st, values, diag, operand_dtype=od),
        "mult3": lambda: jp.mult_three_level_from_values(
            jp.get_three_level_structure(jV, st), st, values, diag, operand_dtype=od),
        "three_level": lambda: jp.three_level_from_values(
            jp.get_three_level_structure(jV, st), st, values, diag, operand_dtype=od),
        "auto": lambda: jp.auto_preconditioner(jV, st, values, diag, operand_dtype=od),
        "smoothed": lambda: jp.smoothed_two_level_matrix_free(st, values, diag, omega=0.8),
        "jacobi": lambda: None,
    }[precond]()
    x, info = jsol.pcg(lambda v: jb.bsr_matvec(st, values, v), b_pad, precond=m,
                       precond_diag=diag if m is None else None, tol=tol, maxiter=600)
    return np.asarray(x), int(info.iterations)


@pytest.fixture(scope="module")
def dfn_bases():
    from test_torch_three_level import bases

    return bases("dfn")


@pytest.mark.parametrize("precond,bf16", [
    ("jacobi", False), ("two_level", False), ("aggblock", False), ("affine", False),
    ("smoothed", False), ("mult", False), ("mult3", False), ("three_level", False),
    ("auto", False), ("aggblock", True), ("two_level", True), ("three_level", True),
    ("mult", True),
])
def test_bench_preconditioners_match_jax(dfn_bases, precond, bf16):
    """``bench.make_bsr_solve(precond=...)``: the repo-root bench.py's
    branch of the same name, the JAX iteration count, within 1e-9."""
    from pytorch_fem_solver_tpu_torch import bench

    jV, pV = dfn_bases
    x, iterations, rel_res = bench.make_bsr_solve(
        pV, tol=1e-10, precond=precond, operand_dtype=torch.bfloat16 if bf16 else None)()
    x_ref, it_ref = _jax_bench(jV, precond, jnp.bfloat16 if bf16 else None, 1e-10)
    assert iterations == it_ref and float(rel_res) <= 1e-10
    assert float(np.linalg.norm(x.numpy() - x_ref) / np.linalg.norm(x_ref)) <= 1e-9
