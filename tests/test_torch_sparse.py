"""PyTorch port, the ELL operator (``ops/sparse.py``) and the segment
operator (``ops/operators.py``).

Both packages build their tables from the same mesh (the port's DFN mesh is
made from the JAX mesh's arrays; the unit squares come from byte-identical
generators), in float64 on the CPU: the h=0.25 seven-fracture DFN (3,216
cells, 1,587 DOFs) and a unit square, each with and without a spill tail.
Every ``ELLStructure`` and ``LoadStructure`` table must be byte-identical
to the JAX one (dtype and bytes), and assembly, SpMV, diagonal and load
assembly on seeded element data must agree to 1e-13 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import operators as jo
from pytorch_fem_solver_tpu.ops import sparse as js
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import operators as po
from pytorch_fem_solver_tpu_torch.ops import sparse as ps

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

REL = 1e-13


def _dfn():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(jax.tree_util.tree_map(np.asarray, jm._t), device="cpu")
    return (
        fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2)),
        pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2)),
    )


def _square():
    return (
        fem.Basis(fem.MeshTri(fem.unit_square(n=8)), fem.ElementTri(1, 2)),
        pt.Basis(pt.MeshTri(pt.unit_square(n=8), device="cpu"), pt.ElementTri(1, 2)),
    )


@pytest.fixture(scope="module")
def dfn():
    jV, pV = _dfn()
    assert (pV.mesh.n_cells, pV.n_dofs) == (3216, 1587)
    return jV, pV


@pytest.fixture(scope="module")
def square():
    return _square()


# (mesh, max_k): the DFN's heaviest rows exceed 8 (trace DOFs), the unit
# square's exceed 4; None keeps every pair in the ELL part
CASES = [("dfn", None), ("dfn", 8), ("square", None), ("square", 4)]


@pytest.fixture(scope="module", params=CASES, ids=[f"{m}-k{k}" for m, k in CASES])
def ell_pair(request, dfn, square):
    mesh, max_k = request.param
    jV, pV = dfn if mesh == "dfn" else square
    js_st = js.build_ell_structure(
        jV._global_dofs4elements, jV.n_dofs,
        np.asarray(jV._basis_parameters["inner_dofs"]), max_k=max_k,
    )
    ps_st = ps.build_ell_structure(
        pV._global_dofs4elements, pV.n_dofs, pV._basis_parameters["inner_dofs"],
        max_k=max_k,
    )
    spills = max_k is not None
    assert (js_st.spill_rows.shape[0] > 0) == spills
    return jV, pV, js_st, ps_st


def _same_bytes(ours, ref):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    return ours.dtype == ref.dtype and ours.shape == ref.shape and ours.tobytes() == ref.tobytes()


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _local(T, seed, trailing=(3, 3)):
    return np.random.default_rng(seed).standard_normal((T,) + trailing)


@pytest.mark.parametrize("field", js.ELLStructure._fields)
def test_ell_tables_are_byte_identical(ell_pair, field):
    _, _, js_st, ps_st = ell_pair
    ours, ref = getattr(ps_st, field), getattr(js_st, field)
    if isinstance(ref, int):
        assert ours == ref
    else:
        assert _same_bytes(ours, ref), field


def test_ell_tables_live_on_the_basis_device_in_int32(ell_pair):
    _, pV, _, st = ell_pair
    for t in (st.cols, st.gather, st.spill_rows, st.spill_cols, st.spill_gather):
        assert t.device == pV.device and t.dtype == torch.int32
    assert st.pad_mask.dtype == torch.float64
    assert isinstance(st.slots, np.ndarray) and isinstance(st.keep, np.ndarray)
    # the SpMV's gathers read int64 copies of the column tables
    for wide, narrow in ((st.cols_index, st.cols), (st.spill_cols_index, st.spill_cols)):
        assert wide.dtype == torch.int64 and wide.device == pV.device
        assert torch.equal(wide, narrow.long())


def test_ell_values_matvec_and_diagonal_match_jax(ell_pair):
    jV, pV, js_st, ps_st = ell_pair
    T = pV.mesh.n_cells
    local = _local(T, 1)
    local = local + np.swapaxes(local, -1, -2)
    ref = js.ell_values_from_local(js_st, jnp.asarray(local))
    ours = ps.ell_values_from_local(ps_st, torch.from_numpy(local))
    assert _rel(ours[0].numpy(), ref[0]) <= REL
    if js_st.spill_rows.shape[0]:
        assert _rel(ours[1].numpy(), ref[1]) <= REL
    else:
        assert ours[1].numel() == 0
    x = np.random.default_rng(2).standard_normal(js_st.n_inner)
    y_ref = js.ell_matvec(js_st, ref, jnp.asarray(x))
    assert _rel(ps.ell_matvec(ps_st, ours, torch.from_numpy(x)).numpy(), y_ref) <= REL
    assert _rel(ps.ell_diagonal(ps_st, ours).numpy(), js.ell_diagonal(js_st, ref)) <= REL


def test_ell_matvec_of_the_stiffness_equals_the_dense_reduced_matrix(dfn):
    """The spill tail holds the DFN trace rows' surplus: with it the ELL
    operator is the assembled reduced stiffness exactly (to roundoff)."""
    _, pV = dfn
    form = lambda b: b.v_grad @ b.v_grad.mT  # noqa: E731
    st = ps.get_ell_structure(pV, max_k=8)
    assert st.spill_rows.shape[0] > 0
    values = ps.ell_values_from_local(st, pV.integrate_bilinear_form_local(form))
    dense = pV.reduce(pV.integrate_bilinear_form(form))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(st.n_inner))
    assert _rel(ps.ell_matvec(st, values, x).numpy(), (dense @ x).numpy()) <= REL
    assert _rel(ps.ell_diagonal(st, values).numpy(), torch.diagonal(dense).numpy()) <= REL


@pytest.mark.parametrize("mesh", ["dfn", "square"])
def test_load_tables_and_assembly_match_jax(mesh, dfn, square):
    jV, pV = dfn if mesh == "dfn" else square
    ref_st = js.build_load_structure(jV._global_dofs4elements, jV.n_dofs)
    st = ps.build_load_structure(pV._global_dofs4elements, pV.n_dofs)
    assert _same_bytes(st.gather, ref_st.gather) and st.n_entries == ref_st.n_entries
    vec = _local(pV.mesh.n_cells, 4, (3, 1))
    ours = ps.load_from_local(st, torch.from_numpy(vec))
    assert _rel(ours.numpy(), js.load_from_local(ref_st, jnp.asarray(vec))) <= REL
    assert _rel(ours.numpy(), pV._assemble_linear_from_local(torch.from_numpy(vec)).numpy()) <= REL


@pytest.mark.parametrize("seed", [0, 1])
def test_invert_scatter_map_is_byte_identical(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 37, size=500)
    pos = rng.permutation(500)
    ref = js.invert_scatter_map(ids, 40, pos, pad=500)
    ours = ps.invert_scatter_map(ids, 40, pos, pad=500)
    assert _same_bytes(ours, ref)


def test_get_ell_structure_caches_per_max_k_and_reduced_operator_matches_jax(dfn):
    jV, pV = dfn
    a = ps.get_ell_structure(pV, max_k=8)
    assert ps.get_ell_structure(pV, max_k=8) is a
    b = ps.get_ell_structure(pV)
    assert b is not a and b.cols.shape[1] > a.cols.shape[1]
    local = _local(pV.mesh.n_cells, 5)
    local = local + np.swapaxes(local, -1, -2)
    matvec, diag = ps.reduced_ell_operator(pV, torch.from_numpy(local))
    matvec_ref, diag_ref = js.reduced_ell_operator(jV, jnp.asarray(local))
    x = np.random.default_rng(6).standard_normal(a.n_inner)
    assert _rel(matvec(torch.from_numpy(x)).numpy(), matvec_ref(jnp.asarray(x))) <= REL
    assert _rel(diag.numpy(), diag_ref) <= REL


@pytest.mark.parametrize("mesh", ["dfn", "square"])
def test_segment_operator_matches_jax(mesh, dfn, square):
    jV, pV = dfn if mesh == "dfn" else square
    local = _local(pV.mesh.n_cells, 7)
    n = pV.n_dofs
    x = np.random.default_rng(8).standard_normal(n)
    dofs_j, dofs_p = jV._global_dofs4elements, pV._global_dofs4elements
    ours = po.local_matvec(torch.from_numpy(local), dofs_p, n, torch.from_numpy(x))
    ref = jo.local_matvec(jnp.asarray(local), dofs_j, n, jnp.asarray(x))
    assert _rel(ours.numpy(), ref) <= REL
    ours = po.operator_diagonal(torch.from_numpy(local), dofs_p, n)
    assert _rel(ours.numpy(), jo.operator_diagonal(jnp.asarray(local), dofs_j, n)) <= REL
    matvec, diag = po.reduced_operator_from_local(pV, torch.from_numpy(local))
    matvec_ref, diag_ref = jo.reduced_operator_from_local(jV, jnp.asarray(local))
    xr = x[: diag.shape[0]]
    assert _rel(matvec(torch.from_numpy(xr)).numpy(), matvec_ref(jnp.asarray(xr))) <= REL
    assert _rel(diag.numpy(), diag_ref) <= REL
