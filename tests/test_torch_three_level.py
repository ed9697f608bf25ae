"""PyTorch port, the additive three-level preconditioner family
(``ops/precondition.py``: ``ThreeLevelStructure``, ``ThreeLevel``,
``build_three_level_structure``, ``get_three_level_structure``,
``three_level_from_values``) against the JAX package in float64.

On the h=0.25 seven-fracture DFN (1,587 DOFs) and ``unit_square(n=16)``:
every ``ThreeLevelStructure`` field byte-identical at (g1, g2) = (32, 32)
and (16, 8); the cache keyed as JAX keys it; ``mblk_inv``, ``acc_inv``
and ``blk_inv`` within 1e-12 relative and the apply on 3 seeded vectors
within 1e-12, on the same assembled values; PCG with the three-level M
takes the JAX iteration count and agrees to 1e-10; a bad ``g1`` raises
the JAX text.
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
from pytorch_fem_solver_tpu.ops import solvers as jsol
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import bsr as pb
from pytorch_fem_solver_tpu_torch.ops import precondition as pp
from pytorch_fem_solver_tpu_torch.ops import solvers as psol

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REL = 1e-12
SOL = 1e-10
G12 = [(32, 32), (16, 8)]


def stiffness(b):
    if isinstance(b.v_grad, torch.Tensor):
        return b.v_grad @ b.v_grad.mT
    return b.v_grad @ jnp.matrix_transpose(b.v_grad)


def bases(mesh):
    """Both packages' P1 basis on the h=0.25 DFN or ``unit_square(n=16)``."""
    if mesh == "dfn":
        jm = jax_network(h=0.25)
        pm = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jm._t), device="cpu")
        return (
            fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2)),
            pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2)),
        )
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(n=16)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.unit_square(n=16), device="cpu"), pt.ElementTri(1, 2)),
    )


def bsr_system(mesh):
    """Both packages' BSR structure (max_b=8) and the JAX package's assembled
    stiffness values, handed to the port as the same numbers."""
    jV, pV = bases(mesh)
    jst, pst = jb.get_bsr_structure(jV, max_b=8), pb.get_bsr_structure(pV, max_b=8)
    jvals = jb.bsr_values_from_local(jst, jV.integrate_bilinear_form_local(stiffness))
    pvals = tuple(torch.from_numpy(np.array(v)) for v in jvals)
    b = np.array(jb.bsr_reduce(jst, jV.integrate_linear_form(lambda v: v.v)))
    return dict(jV=jV, pV=pV, jst=jst, pst=pst, jvals=jvals, pvals=pvals,
                jdiag=jb.bsr_diagonal(jst, jvals), pdiag=pb.bsr_diagonal(pst, pvals), b=b)


@pytest.fixture(scope="module", params=["dfn", "square"])
def system(request):
    return bsr_system(request.param)


def rel(ours, ref) -> float:
    ref = np.asarray(ref)
    ours = ours.detach().numpy()
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / max(np.abs(ref).max(), 1e-300))


def vectors(n, k=3, seed=0):
    return np.random.default_rng(seed).standard_normal((k, n))


@pytest.mark.parametrize("g1,g2", G12)
def test_structure_byte_identical(system, g1, g2):
    ref = jp.build_three_level_structure(system["jst"], g1=g1, g2=g2)
    ours = pp.build_three_level_structure(system["pst"], g1=g1, g2=g2)
    assert ref._fields == ours._fields
    for name in ref._fields:
        a, b = getattr(ref, name), getattr(ours, name)
        if isinstance(a, int):
            assert a == b, name
            continue
        a, b = np.asarray(a), b.numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert a.tobytes() == b.tobytes(), name
    assert ours.n_slots > 0 and ours.nc1p % g2 == 0


def test_cached_per_basis_as_jax_keys_it(system):
    pV, pst = system["pV"], system["pst"]
    tl = pp.get_three_level_structure(pV, pst)
    assert pp.get_three_level_structure(pV, pst) is tl
    key = (pst.nb, pst.bcols.shape[1], pst.heavy_rows.shape[0], 32, 32)
    assert set(pV._three_level_structures) == {key}
    jp.get_three_level_structure(system["jV"], system["jst"])
    assert set(system["jV"]._three_level_structures) == {key}
    assert pp.get_three_level_structure(pV, pst, g2=8) is not tl


@pytest.mark.parametrize("g1,g2", G12)
def test_setup_and_apply_match_jax(system, g1, g2):
    s = system
    jtl = jp.build_three_level_structure(s["jst"], g1=g1, g2=g2)
    ptl = pp.build_three_level_structure(s["pst"], g1=g1, g2=g2)
    ref = jp.three_level_from_values(jtl, s["jst"], s["jvals"], s["jdiag"])
    ours = pp.three_level_from_values(ptl, s["pst"], s["pvals"], s["pdiag"])
    for name in ("blk_inv", "mblk_inv", "acc_inv"):
        assert rel(getattr(ours, name), getattr(ref, name)) <= REL, name
    assert (ours.g1, ours.g2, ours.nc1, ours.nc1p) == (ref.g1, ref.g2, ref.nc1, ref.nc1p)
    for w in vectors(s["pst"].n_pad):
        assert rel(ours(torch.from_numpy(w)), ref(jnp.asarray(w))) <= REL
        assert rel(ours.coarse_apply(torch.from_numpy(w)), ref.coarse_apply(jnp.asarray(w))) <= REL
    # symmetric: <M u, w> == <u, M w>
    u, w = (torch.from_numpy(v) for v in vectors(s["pst"].n_pad, 2, seed=5))
    a, b = torch.dot(ours(u), w), torch.dot(u, ours(w))
    assert abs(float(a - b)) <= 1e-12 * abs(float(a))


def test_pcg_iterations_equal_jax(system):
    s = system
    ref_m = jp.three_level_from_values(
        jp.get_three_level_structure(s["jV"], s["jst"]), s["jst"], s["jvals"], s["jdiag"]
    )
    ours_m = pp.three_level_from_values(
        pp.get_three_level_structure(s["pV"], s["pst"]), s["pst"], s["pvals"], s["pdiag"]
    )
    x_ref, info_ref = jsol.pcg(lambda v: jb.bsr_matvec(s["jst"], s["jvals"], v),
                               jnp.asarray(s["b"]), precond=ref_m, tol=1e-10)
    x, info = psol.pcg(lambda v: pb.bsr_matvec(s["pst"], s["pvals"], v),
                       torch.from_numpy(s["b"]), precond=ours_m, tol=1e-10)
    assert info.iterations == int(info_ref.iterations) > 3
    assert bool(info.converged)
    assert rel(x, x_ref) <= SOL


def test_bad_aggregate_size_raises_the_jax_text(system):
    with pytest.raises(ValueError) as ref:
        jp.build_three_level_structure(system["jst"], g1=12)
    with pytest.raises(ValueError) as ours:
        pp.build_three_level_structure(system["pst"], g1=12)
    assert str(ours.value) == str(ref.value)
