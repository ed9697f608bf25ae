"""PyTorch port, the reduced-precision knobs against the JAX package: bf16
preconditioner operands (``operand_dtype``, ``ops/precondition.py:
_mixed_matvec``) and bf16 SpMV values (``ops/bsr.py`` mixed dtypes,
``compiled_bsr_solver(values_dtype=...)``).

- ``_mixed_matvec`` on bf16 operands against JAX's ``einsum(...,
  preferred_element_type=float32)``: within 1e-6 of max|y| (the order of
  the float32 sums; the products are exact), for the coarse and the
  batched block products; bf16 inputs rounded bitwise alike.
- Every builder's stored bf16 operands (block two-level, aggregate-block,
  affine with both smoothers, three-level, ``auto_preconditioner``)
  bitwise equal to JAX's on the h=0.25 DFN in float64, and each apply
  within 1e-12 relative (exact products summed in float64).
- The plain mixed ``bsr_matvec`` / ``bsr_matvec_cols`` against JAX's for
  bf16 values with float32 x (1e-6 of max|y|), bf16 with float64 x
  (1e-12) and float64 values with float32 x (1e-6).
- ``compiled_bsr_solver`` with ``operand_dtype`` and with ``values_dtype``
  bf16 (float64 basis): the JAX iteration counts, solutions within 1e-10
  of JAX's; the bf16-values solution lies more than 1e-5 from the
  float64 one (the cast happened).
- On the card (``cuda`` marker; skips here): K2's bf16-values
  instantiation against the plain version, float32 and float64 x, bitwise
  repeatable, counted under its own key; any other mixed pair raises.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import precondition as pp

from test_torch_three_level import REL, SOL, bsr_system, rel, stiffness, vectors

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

BF = (jnp.bfloat16, torch.bfloat16)


@pytest.fixture(scope="module")
def system():
    return bsr_system("dfn")


def _bits(t):
    """The raw 16-bit words of a bf16 array of either package."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.int16).numpy()
    return np.asarray(t).view(np.int16)


@pytest.mark.parametrize("eq,shapes", [
    ("ij,j->i", ((300, 300), (300,))),
    ("rij,rj->ri", ((40, 32, 32), (40, 32))),
])
def test_mixed_matvec_matches_preferred_element_type(eq, shapes):
    rng = np.random.default_rng(7)
    mat = rng.standard_normal(shapes[0]).astype(np.float32)
    vec = rng.standard_normal(shapes[1]).astype(np.float32)
    jmat = jnp.asarray(mat).astype(jnp.bfloat16)
    pmat = torch.from_numpy(mat).to(torch.bfloat16)
    assert np.array_equal(_bits(jmat), _bits(pmat))
    ref = np.asarray(jp._mixed_matvec(eq, jmat, jnp.asarray(vec), jnp.float32))
    ours = pp._mixed_matvec(eq, pmat, torch.from_numpy(vec), torch.float32)
    assert ours.dtype == torch.float32 and ref.dtype == np.float32
    assert np.abs(ours.numpy() - ref).max() <= 1e-6 * np.abs(ref).max()
    # a bf16 einsum would round the output to bf16: far outside the bound
    rounded = torch.einsum(eq, pmat, torch.from_numpy(vec).to(torch.bfloat16)).float()
    assert np.abs(rounded.numpy() - ref).max() > 1e-4 * np.abs(ref).max()
    # equal dtypes: the plain product
    same = pp._mixed_matvec(eq, torch.from_numpy(mat), torch.from_numpy(vec), torch.float32)
    assert np.allclose(same.numpy(), np.einsum(eq, mat, vec), rtol=1e-5, atol=1e-4)


def _builders(s):
    """(name, JAX operands, port operands, JAX M, port M) per builder, all
    with bf16 operands."""
    jst, pst, jv, pv, jd, pd = s["jst"], s["pst"], s["jvals"], s["pvals"], s["jdiag"], s["pdiag"]
    jV, pV = s["jV"], s["pV"]
    out = []
    ref = jp.block_two_level_from_values(jst, jv, jd, operand_dtype=BF[0])
    ours = pp.block_two_level_from_values(pst, pv, pd, operand_dtype=BF[1])
    out.append(("block_two_level", ref, ours, ("blk_inv", "coarse_inv")))
    ref = jp.agg_block_two_level_from_values(jst, jv, jd, operand_dtype=BF[0])
    ours = pp.agg_block_two_level_from_values(pst, pv, pd, operand_dtype=BF[1])
    out.append(("agg_block", ref, ours, ("inv_agg", "coarse_inv")))
    jast = jp.get_affine_two_level_structure(jV, jst)
    past = pp.get_affine_two_level_structure(pV, pst)
    for fine, names in (("block_jacobi", ("blk_inv", "coarse_inv")),
                        ("agg_block", ("inv_agg", "coarse_inv"))):
        ref = jp.affine_two_level_from_values(jast, jst, jv, jd, fine=fine, operand_dtype=BF[0])
        ours = pp.affine_two_level_from_values(past, pst, pv, pd, fine=fine, operand_dtype=BF[1])
        out.append((f"affine_{fine}", ref, ours, names))
    ref = jp.three_level_from_values(jp.get_three_level_structure(jV, jst), jst, jv, jd,
                                     operand_dtype=BF[0])
    ours = pp.three_level_from_values(pp.get_three_level_structure(pV, pst), pst, pv, pd,
                                      operand_dtype=BF[1])
    out.append(("three_level", ref, ours, ("blk_inv", "mblk_inv", "acc_inv")))
    ref = jp.auto_preconditioner(jV, jst, jv, jd, operand_dtype=BF[0])
    ours = pp.auto_preconditioner(pV, pst, pv, pd, operand_dtype=BF[1])
    out.append(("auto", ref, ours, ("inv_agg", "coarse_inv")))
    return out


def test_stored_operands_bitwise_jax_and_applies_match(system):
    n = system["pst"].n_pad
    for name, ref, ours, operands in _builders(system):
        for op in operands:
            a, b = getattr(ref, op), getattr(ours, op)
            assert b.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16, (name, op)
            assert np.array_equal(_bits(a), _bits(b)), (name, op)
        if name.startswith("affine"):
            assert ours.W.dtype == torch.float64  # the transfers stay in the values' dtype
        for w in vectors(n):
            assert rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL, name


@pytest.mark.parametrize("vdt,xdt,tol", [
    ("bfloat16", "float32", 1e-6), ("bfloat16", "float64", 1e-12), ("float64", "float32", 1e-6),
])
def test_plain_mixed_bsr_products_match_jax(system, vdt, xdt, tol):
    s = system
    jvals = tuple(v.astype(getattr(jnp, vdt)) for v in s["jvals"])
    pvals = tuple(v.to(getattr(torch, vdt)) for v in s["pvals"])
    x = vectors(s["pst"].n_pad, 1)[0].astype(xdt)
    X = np.random.default_rng(3).standard_normal((s["pst"].n_pad, 2)).astype(xdt)
    for ours, ref in (
        (pb.bsr_matvec(s["pst"], pvals, torch.from_numpy(x)),
         jb.bsr_matvec(s["jst"], jvals, jnp.asarray(x))),
        (pb.bsr_matvec_cols(s["pst"], pvals, torch.from_numpy(X)),
         jb.bsr_matvec_cols(s["jst"], jvals, jnp.asarray(X))),
    ):
        ref = np.asarray(ref)
        assert ours.dtype == getattr(torch, xdt) and ref.dtype == np.dtype(xdt)
        assert np.abs(ours.numpy() - ref).max() <= tol * np.abs(ref).max()


@pytest.fixture(scope="module")
def compiled(system):
    import pytorch_fem_solver_tpu.ops.compiled as jc
    from pytorch_fem_solver_tpu_torch.ops import compiled as pc

    def load(b):
        return b.v

    def both(**kw):
        jkw = {k: BF[0] for k in kw}
        pkw = {k: BF[1] for k in kw}
        u_j, info_j = jc.compiled_bsr_solver(system["jV"], stiffness, load, tol=1e-10, **jkw)()
        u, info = pc.compiled_bsr_solver(system["pV"], stiffness, load, tol=1e-10, **pkw)()
        return (np.asarray(u_j), int(info_j.iterations)), (u, info)

    return both


@pytest.mark.parametrize("knob", ["operand_dtype", "values_dtype"])
def test_compiled_bsr_solver_knobs_match_jax(compiled, knob):
    (u_j, it_j), (u, info) = compiled(**{knob: True})
    assert info.iterations == it_j and bool(info.converged)
    assert u.dtype == torch.float64
    assert rel(u, u_j) <= SOL
    (_, it_full), (u_full, _) = compiled()
    du = float((u - u_full).abs().max() / u_full.abs().max())
    if knob == "values_dtype":
        assert du > 1e-5  # the PCG solved the bf16-rounded operator
    else:
        assert du <= 1e-8  # the operands only shape the search directions


@pytest.mark.cuda
@pytest.mark.parametrize("xdt,tol", [(torch.float32, 1e-6), (torch.float64, 1e-12)])
def test_k2_bf16_values_kernel_matches_plain_on_card(system, xdt, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 is a CUDA kernel with no CPU mode")
    pst = system["pst"]
    st = pst._replace(
        bcols=pst.bcols.cuda(), bcols2=pst.bcols2.cuda(), heavy_rows=pst.heavy_rows.cuda(),
        row_blocks=pst.row_blocks.cuda(), heavy_rank=pst.heavy_rank.cuda(),
    )
    vals = tuple(v.to("cuda", torch.bfloat16).contiguous() for v in system["pvals"])
    x = torch.from_numpy(vectors(pst.n_pad, 1)[0]).to("cuda", xdt)
    before = dict(cuda_build.launch_counts)
    y = pb.bsr_matvec(st, vals, x)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["bsr_spmv_bf16"] == before["bsr_spmv_bf16"] + 1
    assert cuda_build.launch_counts["bsr_spmv"] == before["bsr_spmv"]
    ref = pb._bsr_spmv_plain(st.bcols, vals[0], x, st.bcols2, vals[1], st.heavy_rows)
    assert y.dtype == xdt
    assert float((y - ref).abs().max()) <= tol * float(ref.abs().max())
    assert torch.equal(pb.bsr_matvec(st, vals, x), y)  # bitwise repeatable
    with pytest.raises(TypeError, match="float16"):
        pb.bsr_matvec(st, tuple(v.half() for v in vals), x)
