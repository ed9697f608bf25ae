"""PyTorch port, BSR layer and kernel K2 (BSR SpMV), aggregate two-level.

Host tables must be byte-identical to the JAX package's; the plain SpMV
agrees with ``bsr_matvec`` to 1e-13 (float64 values on a float32 x to 1e-6
of max |y|, the JAX package's mixed-dtype sums); assembled values, the diagonal and the
aggregate-block preconditioner (setup and apply) to 1e-10. The tables the
port adds for its SpMV kernel (``row_blocks``, ``heavy_rank``) are held
against the JAX tables they summarise, for a narrow tier 1 (``max_b=4``),
the default (8) and no tier 2 (``max_b=None``). The kernel runs only on a
card (``cuda`` marker); ``chip_smoke.py`` holds it against the plain version
at the benchmark size and on the same three structures.
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


MAX_BS = [4, 8, None]


@pytest.fixture(scope="module")
def systems(setup):
    """``max_b -> (jst, pst, jvals, pvals)``: structure and symmetric
    assembly of both packages, built once per tier-1 width."""
    jV, pV, jst8, pst8, jvals8, pvals8 = setup
    out = {8: (jst8, pst8, jvals8, pvals8)}
    for max_b in (4, None):
        jst = jb.get_bsr_structure(jV, max_b=max_b)
        pst = pb.get_bsr_structure(pV, max_b=max_b)
        out[max_b] = (
            jst,
            pst,
            jb.bsr_values_from_local_symmetric(
                jst, jV.integrate_bilinear_form_local(a_form_j)
            ),
            pb.bsr_values_from_local_symmetric(
                pst, pV.integrate_bilinear_form_local(a_form_p)
            ),
        )
    return out


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
    # the SpMV kernel's tables and the int64 device copies of the gather
    # tables are the port's own; every JAX table stays
    assert set(pst._fields) - set(jst._fields) == {
        "row_blocks", "heavy_rank", "inner_perm_index", "tpartner_index", "tperm"
    }
    for name in jst._fields:
        ours, ref = getattr(pst, name), getattr(jst, name)
        if isinstance(ours, int):
            continue
        if isinstance(ours, torch.Tensor):
            assert ours.dtype == torch.int32, name
            ours = ours.numpy()
        np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=name)


@pytest.mark.parametrize("max_b", MAX_BS)
def test_structure_from_numpy_round_trip(systems, max_b):
    jst, pst, _, _ = systems[max_b]
    assert pst.row_blocks is not None and pst.heavy_rank is not None
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


@pytest.mark.parametrize("max_b", MAX_BS)
def test_row_tables_agree_with_structure(systems, max_b):
    """``row_blocks`` and ``heavy_rank`` against ``bcols``/``bcols2``/
    ``heavy_rows``/``blk_id_host``: what the kernel skips is padding."""
    _, pst, _, pvals = systems[max_b]
    nb, B = pst.bcols.shape
    nh, B2 = pst.bcols2.shape
    assert (nh > 0) == (max_b is not None)
    if max_b == 4:
        assert B == 4 and B2 > 4  # a tier 2 wider than tier 1
    for table in (pst.row_blocks, pst.heavy_rank):
        assert table.dtype == torch.int32 and table.shape == (nb,)
    counts = pst.row_blocks.numpy().astype(np.int64)
    rank = pst.heavy_rank.numpy().astype(np.int64)
    heavy = pst.heavy_rows.numpy()

    # counts: every stored block once, split as min(c, B) + max(c - B, 0)
    assert counts.sum() == pst.blk_id_host.size == pst.ubr_host.size
    np.testing.assert_array_equal(counts, np.bincount(pst.ubr_host, minlength=nb))
    assert counts.max() == B + B2
    in1 = np.minimum(counts, B)
    in2 = counts - in1
    assert in1.sum() == (pst.blk_id_host < nb * B).sum()
    assert in2.sum() == (pst.blk_id_host >= nb * B).sum()

    # heavy_rank inverts heavy_rows and is -1 exactly where nothing spills
    np.testing.assert_array_equal(rank[heavy], np.arange(nh))
    np.testing.assert_array_equal(np.nonzero(rank >= 0)[0], heavy)
    np.testing.assert_array_equal(rank >= 0, in2 > 0)

    # slots are filled from the front: the stored flat ids are the first
    # in1 slots of each tier-1 row and the first in2 of its tier-2 row
    front1 = np.arange(B)[None, :] < in1[:, None]
    front2 = np.arange(B2)[None, :] < in2[heavy][:, None]
    stored = np.zeros(nb * B + nh * B2, dtype=bool)
    stored[pst.blk_id_host] = True
    np.testing.assert_array_equal(stored[: nb * B].reshape(nb, B), front1)
    np.testing.assert_array_equal(stored[nb * B :].reshape(nh, B2), front2)
    # ... the padding behind them points at block 0 (an empty row's slot 0
    # at itself) and holds zero values after assembly
    pad_cols = pst.bcols.numpy()[~front1]
    own = np.broadcast_to(np.arange(nb)[:, None], (nb, B))[~front1]
    assert ((pad_cols == 0) | (pad_cols == own)).all()
    assert (pst.bcols2.numpy()[~front2] == 0).all()
    v1, v2 = (v.numpy() for v in pvals)
    assert not v1[~front1].any() and not v2[~front2].any()


@pytest.mark.parametrize("max_b", MAX_BS)
def test_padding_free_walk_matches_plain(systems, max_b):
    """The kernel's walk, written out with NumPy: block-row r sums its
    ``row_blocks[r]`` blocks, the first B from tier 1 and the rest from row
    ``heavy_rank[r]`` of tier 2, and touches no other slot (the padding is
    poisoned with NaN here)."""
    _, pst, _, pvals = systems[max_b]
    nb, B = pst.bcols.shape
    counts, rank = pst.row_blocks.numpy(), pst.heavy_rank.numpy()
    cols1, cols2 = pst.bcols.numpy(), pst.bcols2.numpy()
    x = np.random.default_rng(3).standard_normal(pst.n_pad)
    ref = pb._bsr_spmv_plain(
        pst.bcols, pvals[0], torch.from_numpy(x), pst.bcols2, pvals[1], pst.heavy_rows
    ).numpy()
    v1, v2 = (v.numpy().copy() for v in pvals)
    v1[np.arange(B)[None, :] >= counts[:, None]] = np.nan
    if v2.size:
        spilled = (counts - B)[pst.heavy_rows.numpy()]
        v2[np.arange(v2.shape[1])[None, :] >= spilled[:, None]] = np.nan
    x2 = x.reshape(nb, 8)
    y = np.zeros((nb, 8))
    for r in range(nb):
        for t in range(counts[r]):
            if t < B:
                y[r] += v1[r, t] @ x2[cols1[r, t]]
            else:
                y[r] += v2[rank[r], t - B] @ x2[cols2[rank[r], t - B]]
    assert np.isfinite(y).all()
    assert _rel(y.reshape(-1), ref) <= 1e-13


@pytest.mark.parametrize("symmetric", [True, False])
def test_assembled_values_and_diagonal(setup, symmetric):
    jV, pV, jst, pst, jvals, pvals = setup
    if not symmetric:
        jvals = jb.bsr_values_from_local(jst, jV.integrate_bilinear_form_local(a_form_j))
        pvals = pb.bsr_values_from_local(pst, pV.integrate_bilinear_form_local(a_form_p))
    for ours, ref in zip(pvals, jvals):
        assert _rel(ours, ref) <= 1e-10
    assert _rel(pb.bsr_diagonal(pst, pvals), jb.bsr_diagonal(jst, jvals)) <= 1e-10


@pytest.mark.parametrize("max_b", MAX_BS)
def test_plain_spmv_matches_jax(systems, max_b):
    jst, pst, jvals, _ = systems[max_b]
    rng = np.random.default_rng(11)
    x = rng.standard_normal(pst.n_pad)
    vals = tuple(torch.from_numpy(np.array(v)) for v in jvals)  # same inputs
    ours = pb.bsr_matvec(pst, vals, torch.from_numpy(x))
    ref = jb.bsr_matvec(jst, jvals, jnp.asarray(x))
    assert _rel(ours, ref) <= 1e-13
    # float64 values on a float32 x: x rounded to the values' dtype, sums
    # in float32, as the JAX package computes it
    ours32 = pb.bsr_matvec(pst, vals, torch.from_numpy(x).float())
    ref32 = np.asarray(jb.bsr_matvec(jst, jvals, jnp.asarray(x, dtype=jnp.float32)))
    assert ours32.dtype == torch.float32 and ref32.dtype == np.float32
    assert np.abs(ours32.numpy() - ref32).max() <= 1e-6 * np.abs(ref32).max()


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


@pytest.mark.parametrize("n", [8, 32, 64])
def test_small_inverses_match_jax(n):
    """The plain Gauss-Jordan (K7's reference on the card) against the JAX
    package's at the 8 x 8 block-Jacobi blocks and the cells' g2 and gs;
    the Cholesky inverse at n = 8."""
    rng = np.random.default_rng(7)
    m = rng.standard_normal((5, n, n))
    spd = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    ours = pp.batched_small_inv(torch.from_numpy(spd))
    assert _rel(ours, jp.batched_small_inv(jnp.asarray(spd))) <= 1e-12
    if n != 8:
        return
    assert _rel(pp.spd_inverse(torch.from_numpy(spd[0])), jp.spd_inverse(jnp.asarray(spd[0]))) <= 1e-12
    # indefinite input: Cholesky fails, the LU inverse takes over
    indef = spd[1] - 40 * np.eye(8)
    inv = pp.spd_inverse(torch.from_numpy(indef))
    assert np.allclose(inv.numpy() @ indef, np.eye(8), atol=1e-10)
    assert _rel(inv, jp.spd_inverse(jnp.asarray(indef))) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("max_b", MAX_BS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_kernel_matches_plain_on_card(systems, dtype, tol, max_b):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    _, pst, _, pvals = systems[max_b]
    st = pst._replace(
        bcols=pst.bcols.cuda(), bcols2=pst.bcols2.cuda(), heavy_rows=pst.heavy_rows.cuda(),
        row_blocks=pst.row_blocks.cuda(), heavy_rank=pst.heavy_rank.cuda(),
    )
    vals = tuple(v.to("cuda", dtype).contiguous() for v in pvals)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(pst.n_pad)).to("cuda", dtype)
    before = cuda_build.launch_counts["bsr_spmv"]
    y = pb.bsr_matvec(st, vals, x)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["bsr_spmv"] == before + 1
    ref = pb._bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
    assert float((y - ref).norm() / ref.norm()) <= tol
    assert torch.equal(pb.bsr_matvec(st, vals, x), y)  # bitwise repeatable
    with pytest.raises(ValueError, match="row_blocks"):
        pb.bsr_matvec(st._replace(row_blocks=None), vals, x)
