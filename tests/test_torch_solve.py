"""PyTorch port, the slice end to end: PCG and the two solve paths.

Both packages solve the seven-fracture DFN in float64 from the same mesh
(the port's mesh is built from the JAX mesh's arrays). PCG iteration counts
must be equal and solutions agree to 1e-9 relative, at h=0.25 (3,216 cells)
and h=0.1 (19,680 cells):

* the benchmark path (``pytorch_fem_solver_tpu_torch/bench.py``: K1 rows ->
  canonical-pair scatter -> aggblock -> PCG with K2) against the same
  composition of JAX functions (``_p1_xla_3d`` rows, ``.at[].add``,
  ``bsr_complete_symmetric``, ``agg_block_two_level_from_values``, ``pcg``);
* ``compiled_bsr_solver`` against the JAX one.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import bsr as jb
from pytorch_fem_solver_tpu.ops import pallas_kernels as jk
from pytorch_fem_solver_tpu.ops import precondition as jp
from pytorch_fem_solver_tpu.ops.solvers import pcg as jax_pcg
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import bench, config, interop
from pytorch_fem_solver_tpu_torch.ops.compiled import compiled_bsr_solver
from pytorch_fem_solver_tpu_torch.ops.solvers import pcg

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

TOL = 1e-10


def _bases(h):
    jm = jax_network(h=h)
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device="cpu"
    )
    return (
        fem.FractureNetworkBasis(jm, fem.ElementTri(1, 2)),
        pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2)),
    )


@pytest.fixture(scope="module", params=[0.25, 0.1], ids=["h0.25", "h0.1"])
def bases(request):
    jV, pV = _bases(request.param)
    expected = {0.25: (3216, 1587), 0.1: (19680, 9795)}[request.param]
    assert (pV.mesh.n_cells, pV.n_dofs) == expected
    return jV, pV


def _jax_bench_path(jV, tol):
    """bench.py's aggblock composition, with the (6, T) pairs and (3, T)
    load taken from the JAX element kernel's rows as the port does."""
    st = jb.get_bsr_structure(jV, max_b=8, want_entry_slot=False)
    T = jV.mesh.n_cells
    out = jk._p1_xla_3d(jk.coords_to_soa_3d(jV.mesh["cells", "coordinates_3d"]))[:, :T]
    iu, ju = np.triu_indices(3)
    e6 = out[np.asarray(bench.SYM_ROWS)] * jnp.asarray(np.where(iu == ju, 0.5, 1.0))[:, None]
    slots_T = np.asarray(st.entry_slot_sym).reshape(T, 6).T.reshape(-1)
    vals = jnp.zeros(st.n_values).at[slots_T].add(e6.reshape(-1), mode="drop")
    values = jb.bsr_complete_symmetric(st, vals)
    dofs_pad_T = jb.inverse_inner_perm(st, jV.n_dofs)[
        np.asarray(jV._global_dofs4elements).T.reshape(-1)
    ]
    b_pad = jnp.zeros(st.n_pad).at[dofs_pad_T].add(out[9:12].reshape(-1), mode="drop")
    diag = jb.bsr_diagonal(st, values)
    g = jp.default_aggregate_size(st)
    precond = jp.agg_block_two_level_from_values(
        st, values, diag, g=g, gs=min(g, 128),
        table=jp.build_agg_block_table(st, min(g, 128)),
    )
    x, info = jax_pcg(
        lambda v: jb.bsr_matvec(st, values, v), b_pad, precond=precond,
        tol=tol, maxiter=600,
    )
    return np.asarray(x), int(info.iterations)


def _rel_diff(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_bench_path_matches_jax_composition(bases):
    jV, pV = bases
    x, iters, rel = bench.make_bsr_solve(pV, tol=TOL)()
    x_ref, iters_ref = _jax_bench_path(jV, TOL)
    assert iters == iters_ref
    assert float(rel) <= TOL
    assert _rel_diff(x.numpy(), x_ref) <= 1e-9


def _compiled_pair(jV, pV, precondition):
    u, info = pV.compiled_solver(
        lambda b: b.v_grad @ b.v_grad.mT, lambda b: b.v,
        tol=TOL, precondition=precondition,
    )()
    u_ref, info_ref = jV.compiled_solver(
        lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad), lambda b: b.v,
        tol=TOL, precondition=precondition,
    )()
    assert info.iterations == int(info_ref.iterations)
    assert bool(info.converged) and bool(info_ref.converged)
    assert _rel_diff(u.numpy(), np.asarray(u_ref)) <= 1e-9


def test_compiled_bsr_solver_matches_jax(bases):
    _compiled_pair(*bases, "auto")


def test_compiled_solver_jacobi_nonsymmetric_and_assembled_rhs():
    """The Jacobi branch, symmetric_form=False (the per-entry scatter) and a
    caller-assembled rhs, each in the JAX iteration count."""
    jV, pV = _bases(0.25)
    _compiled_pair(jV, pV, "jacobi")
    a_p = lambda b: b.v_grad @ b.v_grad.mT  # noqa: E731
    u_sym, info_sym = pV.compiled_solver(a_p, lambda b: b.v, tol=TOL)()
    b_full = torch.zeros(pV.n_dofs, dtype=torch.float64).index_add_(
        0,
        pV._global_dofs4elements.reshape(-1).long(),
        pV.integrate_linear_form_local(lambda b: b.v).reshape(-1),
    )[:, None]
    u, info = pV.compiled_solver(a_p, symmetric_form=False, tol=TOL)(b_full)
    u_ref, info_ref = jV.compiled_solver(
        lambda b: b.v_grad @ jnp.matrix_transpose(b.v_grad),
        symmetric_form=False, tol=TOL,
    )(jnp.asarray(b_full.numpy()))
    assert info.iterations == int(info_ref.iterations)
    assert _rel_diff(u.numpy(), np.asarray(u_ref)) <= 1e-9
    assert _rel_diff(u.numpy(), u_sym.numpy()) <= 1e-9


def test_unported_options_raise(monkeypatch):
    """The vector branch of compiled_bsr_solver builds the rigid-body-mode
    tables at construction, before any solve (m = 3 in 2D), and no
    aggregate-block table; with ``"jacobi"`` it builds neither. Above 2M cells a
    symmetric form picks the chunked assembly, 2^18 cells per chunk, as the
    JAX package does (a stub basis; the structure and the solver are stubs
    too, so nothing is built), and a non-symmetric one stays unchunked. An
    unknown preconditioner name is refused."""
    import pytorch_fem_solver_tpu_torch.ops.compiled as compiled

    a_p = lambda b: b.v_grad @ b.v_grad.mT  # noqa: E731
    def vector_laplacian(b):
        return torch.einsum("...icd,...jcd->...ij", b.v_grad, b.v_grad)

    mesh = pt.MeshTri(pt.unit_square(n=4), device="cpu")
    for precondition, kinds in (("jacobi", set()), ("auto", {"rbm"})):
        V = pt.VectorBasis(mesh, pt.ElementTri(1, 2))
        compiled_bsr_solver(V, vector_laplacian, None, precondition=precondition)
        tables = getattr(V, "_affine_two_level_structures", {})
        assert {key[-1] for key in tables} == kinds
        assert all(ast.m == 3 for ast in tables.values())
        assert not hasattr(V, "_agg_block_tables")
    n_cells = 2_000_001
    slots = torch.zeros((), dtype=torch.int32).expand(10 * n_cells)  # no memory
    monkeypatch.setattr(compiled, "get_bsr_structure",
                        lambda *a, **k: SimpleNamespace(entry_slot_sym=slots))
    monkeypatch.setattr(compiled, "bsr_pcg", lambda *a, **k: None)
    for symmetric, chunks in ((True, 8), (False, None)):
        huge = SimpleNamespace(v_grad=torch.empty(n_cells, 0), _basis_parameters={}, n_dofs=1)
        compiled_bsr_solver(huge, a_p, lambda b: b.v, max_b=24, symmetric_form=symmetric)
        tables = getattr(huge, "_chunk_tables", None)
        if chunks is None:
            assert tables is None
        else:
            assert list(tables) == [(1 << 18, 24)] and len(tables[(1 << 18, 24)]) == chunks
            c0, c1, view = tables[(1 << 18, 24)][-1]
            assert (c0, c1, view.shape[0]) == (7 << 18, n_cells, 10 * (n_cells - (7 << 18)))
    monkeypatch.undo()
    _, pV = _bases(0.25)
    with pytest.raises(ValueError, match="unknown precondition"):
        pV.compiled_solver(a_p, lambda b: b.v, precondition="ilu")


def test_pcg_matches_jax_on_a_dense_spd_system():
    rng = np.random.default_rng(4)
    m = rng.standard_normal((60, 60))
    a = m @ m.T + 0.5 * np.eye(60)
    b = rng.standard_normal(60)
    d = np.diag(a).copy()
    at = torch.from_numpy(a)
    x, info = pcg(lambda v: at @ v, torch.from_numpy(b), precond_diag=torch.from_numpy(d), tol=1e-12)
    xr, info_r = jax_pcg(
        lambda v: jnp.asarray(a) @ v, jnp.asarray(b), precond_diag=jnp.asarray(d), tol=1e-12
    )
    assert info.iterations == int(info_r.iterations)
    assert bool(info.converged)
    assert _rel_diff(x.numpy(), np.asarray(xr)) <= 1e-9
    # the maxiter cap stops the loop and reports non-convergence
    _, capped = pcg(lambda v: at @ v, torch.from_numpy(b), tol=1e-14, maxiter=3)
    assert capped.iterations == 3 and not bool(capped.converged)
