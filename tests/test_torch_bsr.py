"""PyTorch port, BSR layer and kernel K2 (BSR SpMV), aggregate two-level.

Host tables must be byte-identical to the JAX package's; the plain SpMV
agrees with ``bsr_matvec`` to 1e-13; assembled values, the diagonal and the
aggregate-block preconditioner (setup and apply) to 1e-10. The kernel runs
only on a card (``cuda`` marker); ``chip_smoke.py`` holds it against the
plain version at the benchmark size.
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
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import precondition as pp

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


def a_form_j(b):
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def a_form_p(b):
    return b.v_grad @ b.v_grad.mT


@pytest.fixture(scope="module")
def setup():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device="cpu"
    )
    jV = fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2))
    pV = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    jst = jb.get_bsr_structure(jV, max_b=8)
    pst = pb.get_bsr_structure(pV, max_b=8)
    jvals = jb.bsr_values_from_local_symmetric(
        jst, jV.integrate_bilinear_form_local(a_form_j)
    )
    pvals = pb.bsr_values_from_local_symmetric(
        pst, pV.integrate_bilinear_form_local(a_form_p)
    )
    return jV, pV, jst, pst, jvals, pvals


def _rel(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300)


def test_structure_byte_identical(setup):
    _, _, jst, pst, _, _ = setup
    assert (pst.n_inner, pst.n_pad, pst.nb, pst.block, pst.n_values) == (
        jst.n_inner, jst.n_pad, jst.nb, jst.block, jst.n_values
    )
    assert pst.n_pad == 1280
    assert pst.heavy_rows.shape[0] > 0  # the tier-2 path is exercised
    for name in pst._fields:
        ours, ref = getattr(pst, name), getattr(jst, name)
        if isinstance(ours, int):
            continue
        if isinstance(ours, torch.Tensor):
            assert ours.dtype == torch.int32, name
            ours = ours.numpy()
        np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=name)


def test_structure_from_numpy_round_trip(setup):
    _, _, jst, pst, _, _ = setup
    fields = {
        k: (v if isinstance(v, int) or v is None else np.asarray(v))
        for k, v in jst._asdict().items()
    }
    st = interop.structure_from_numpy(fields, device="cpu")
    for name in st._fields:
        a, b = getattr(st, name), getattr(pst, name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), name
        elif isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, name


@pytest.mark.parametrize("symmetric", [True, False])
def test_assembled_values_and_diagonal(setup, symmetric):
    jV, pV, jst, pst, jvals, pvals = setup
    if not symmetric:
        jvals = jb.bsr_values_from_local(jst, jV.integrate_bilinear_form_local(a_form_j))
        pvals = pb.bsr_values_from_local(pst, pV.integrate_bilinear_form_local(a_form_p))
    for ours, ref in zip(pvals, jvals):
        assert _rel(ours, ref) <= 1e-10
    assert _rel(pb.bsr_diagonal(pst, pvals), jb.bsr_diagonal(jst, jvals)) <= 1e-10


def test_plain_spmv_matches_jax(setup):
    jV, pV, jst, pst, jvals, _ = setup
    rng = np.random.default_rng(11)
    x = rng.standard_normal(pst.n_pad)
    vals = tuple(torch.from_numpy(np.array(v)) for v in jvals)  # same inputs
    ours = pb.bsr_matvec(pst, vals, torch.from_numpy(x))
    ref = jb.bsr_matvec(jst, jvals, jnp.asarray(x))
    assert _rel(ours, ref) <= 1e-13
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pb.bsr_matvec(pst, vals, torch.from_numpy(x).float())


def test_reduce_expand_inverse_perm(setup):
    jV, pV, jst, pst, _, _ = setup
    rng = np.random.default_rng(5)
    b = rng.standard_normal((pV.n_dofs, 1))
    red = pb.bsr_reduce(pst, torch.from_numpy(b))
    np.testing.assert_array_equal(red.numpy(), np.asarray(jb.bsr_reduce(jst, jnp.asarray(b))))
    np.testing.assert_array_equal(
        pb.bsr_expand(pst, red, pV.n_dofs).numpy(),
        np.asarray(jb.bsr_expand(jst, jnp.asarray(red.numpy()), pV.n_dofs)),
    )
    np.testing.assert_array_equal(
        pb.inverse_inner_perm(pst, pV.n_dofs), jb.inverse_inner_perm(jst, pV.n_dofs)
    )
    assert pb.default_max_b(pV) == jb.default_max_b(jV) == 8


def test_agg_block_table_and_sizes(setup):
    _, _, jst, pst, _, _ = setup
    g = pp.default_aggregate_size(pst)
    assert g == jp.default_aggregate_size(jst) == 32
    for gs in (8, 32):
        np.testing.assert_array_equal(
            pp.build_agg_block_table(pst, gs), jp.build_agg_block_table(jst, gs)
        )
    for n_pad, base, mult0 in [(1280, 32, 1), (32 * 7489, 32, 2), (4096, 32, 3)]:
        assert pp._bounded_divisor_search(n_pad, base, mult0) == jp._bounded_divisor_search(
            n_pad, base, mult0
        )


def test_agg_block_two_level_setup_and_apply(setup):
    jV, pV, jst, pst, jvals, pvals = setup
    pdiag = pb.bsr_diagonal(pst, pvals)
    jdiag = jb.bsr_diagonal(jst, jvals)
    g = pp.default_aggregate_size(pst)
    ours = pp.agg_block_two_level_from_values(
        pst, pvals, pdiag, g=g, gs=g, table=pp.build_agg_block_table(pst, g)
    )
    ref = jp.agg_block_two_level_from_values(
        jst, jvals, jdiag, g=g, gs=g, table=jp.build_agg_block_table(jst, g)
    )
    assert (ours.g, ours.gs) == (ref.g, ref.gs)
    assert _rel(ours.inv_agg, ref.inv_agg) <= 1e-10
    assert _rel(ours.coarse_inv, ref.coarse_inv) <= 1e-10
    r = np.random.default_rng(2).standard_normal(pst.n_pad)
    assert _rel(ours(torch.from_numpy(r)), ref(jnp.asarray(r))) <= 1e-10
    base = pp.block_two_level_from_values(pst, pvals, pdiag, g=g)
    jbase = jp.block_two_level_from_values(jst, jvals, jdiag, g=g)
    assert _rel(base(torch.from_numpy(r)), jbase(jnp.asarray(r))) <= 1e-10


def test_small_inverses_match_jax():
    rng = np.random.default_rng(7)
    m = rng.standard_normal((5, 8, 8))
    spd = m @ m.transpose(0, 2, 1) + 8 * np.eye(8)
    ours = pp.batched_small_inv(torch.from_numpy(spd))
    assert _rel(ours, jp.batched_small_inv(jnp.asarray(spd))) <= 1e-12
    assert _rel(pp.spd_inverse(torch.from_numpy(spd[0])), jp.spd_inverse(jnp.asarray(spd[0]))) <= 1e-12
    # indefinite input: Cholesky fails, the LU inverse takes over
    indef = spd[1] - 40 * np.eye(8)
    inv = pp.spd_inverse(torch.from_numpy(indef))
    assert np.allclose(inv.numpy() @ indef, np.eye(8), atol=1e-10)
    assert _rel(inv, jp.spd_inverse(jnp.asarray(indef))) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_kernel_matches_plain_on_card(setup, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    _, _, _, pst, _, pvals = setup
    st = pst._replace(
        bcols=pst.bcols.cuda(), bcols2=pst.bcols2.cuda(), heavy_rows=pst.heavy_rows.cuda()
    )
    vals = tuple(v.to("cuda", dtype).contiguous() for v in pvals)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(pst.n_pad)).to("cuda", dtype)
    before = cuda_build.launch_counts["bsr_spmv"]
    y = pb.bsr_matvec(st, vals, x)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["bsr_spmv"] == before + 1
    ref = pb._bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
    assert float((y - ref).norm() / ref.norm()) <= tol
