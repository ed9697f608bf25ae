"""PyTorch port, the chunked assembly of ``compiled_bsr_solver``.

The twin of ``tests/test_compiled.py``'s chunked tests: on
``unit_cube(4)`` (384 tets) with a variable-coefficient stiffness that
reads ``integration_points`` and a load that does too, the chunked solve
(``chunk_cells`` 1, 100, 384 and 1,000: one cell per chunk, a ragged last
chunk, one chunk, a chunk past the mesh) is bitwise the unchunked one on
the CPU, as the JAX test holds its own pair: each chunk's element matrices
are the unchunked ones row for row, and ``index_add_`` on the CPU adds in
source order, so every slot sums the same terms in the same order. Both
agree with the JAX package's chunked solve to 1e-12 relative with equal
PCG iteration counts, at P1 and at P2. The view's guard names "chunked
assembly", a non-symmetric form with ``chunk_cells`` raises the JAX
``ValueError``, the per-chunk slot views are cached on the basis and
reused by a second build, and they are views of the structure's
``entry_slot_sym``, not copies. The solver's ``_assemble_symmetric``
over those chunks is bitwise ``bsr_values_from_local_symmetric``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.element import ElementTet
from pytorch_fem_solver_tpu.mesh import MeshTet, unit_cube
from pytorch_fem_solver_tpu_torch import config
from pytorch_fem_solver_tpu_torch.ops.bsr import bsr_values_from_local_symmetric, get_bsr_structure
from pytorch_fem_solver_tpu_torch.ops.compiled import _assemble_symmetric, _chunk_table

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)

N = 4
TOL = 1e-12


def _var_stiffness(b):
    x = b.integration_points[..., 0:1]
    vg = b.v_grad
    vgt = vg.mT if isinstance(vg, torch.Tensor) else jnp.matrix_transpose(vg)
    return (1.0 + x**2) * (vg @ vgt)


def _load3(b):
    return (1.0 + b.integration_points[..., 2:3]) * b.v


def _port_basis(order=1, n=N):
    return pt.Basis(pt.MeshTet(pt.unit_cube(n), device="cpu"), pt.ElementTet(order, 2 * order))


@pytest.fixture(scope="module", params=[1, 2], ids=["P1", "P2"])
def jax_chunked(request):
    order = request.param
    n = N if order == 1 else 2
    V = fem.Basis(MeshTet(unit_cube(n)), ElementTet(order, 2 * order))
    u, info = V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=100)()
    return order, n, np.asarray(u), int(info.iterations)


@pytest.mark.parametrize("chunk_cells", [1, 100, 384, 1000])
def test_chunked_equals_unchunked_bitwise_and_jax(jax_chunked, chunk_cells):
    order, n, u_jax, iters_jax = jax_chunked
    V = _port_basis(order, n)
    u_plain, info_plain = V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=0)()
    u_chunk, info = V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=chunk_cells)()
    assert bool(info.converged)
    assert torch.equal(u_chunk, u_plain)
    assert info.iterations == info_plain.iterations == iters_jax
    rel = float(np.abs(u_chunk.numpy() - u_jax).max() / np.abs(u_jax).max())
    assert rel <= 1e-12
    n_cells = V.v_grad.shape[0]
    chunks = V._chunk_tables[(chunk_cells, 24)]
    assert len(chunks) == -(-n_cells // chunk_cells)
    assert chunks[-1][1] == n_cells and chunks[-1][1] - chunks[-1][0] <= chunk_cells


@pytest.mark.parametrize("chunk_cells", [1, 100, 1000])
def test_values_from_chunks_equal_the_whole_mesh(chunk_cells):
    V = _port_basis()
    st = get_bsr_structure(V, max_b=24, want_entry_slot=False)
    whole = bsr_values_from_local_symmetric(st, V.integrate_bilinear_form_local(_var_stiffness))
    chunks = _chunk_table(V, st, chunk_cells, 24)
    streamed, none = _assemble_symmetric(V, st, _var_stiffness, chunks)
    assert none is None  # no load asked for
    assert all(torch.equal(a, b) for a, b in zip(streamed, whole))
    # no chunk table: the whole mesh as one run, the form on the basis itself
    one, _ = _assemble_symmetric(V, st, _var_stiffness, None)
    assert all(torch.equal(a, b) for a, b in zip(one, whole))


def test_chunk_tables_are_cached_views(jax_chunked):
    order, n, _, _ = jax_chunked
    V = _port_basis(order, n)
    first = V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=100)
    table = V._chunk_tables[(100, 24)]
    again = V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=100)
    assert V._chunk_tables[(100, 24)] is table and list(V._chunk_tables) == [(100, 24)]
    slots = get_bsr_structure(V, max_b=24, want_entry_slot=False).entry_slot_sym
    pairs = slots.shape[0] // V.v_grad.shape[0]
    for c0, c1, view in table:
        assert view.untyped_storage().data_ptr() == slots.untyped_storage().data_ptr()
        assert torch.equal(view, slots[c0 * pairs: c1 * pairs])
    u1, _ = first()
    u2, _ = again()
    assert torch.equal(u1, u2) and torch.equal(u1, first()[0])


def test_default_leaves_small_meshes_unchunked():
    V = _port_basis()
    u, _ = V.compiled_solver(_var_stiffness, _load3, tol=TOL)()
    assert not hasattr(V, "_chunk_tables")
    assert torch.equal(u, V.compiled_solver(_var_stiffness, _load3, tol=TOL, chunk_cells=0)()[0])


def test_view_guard_names_chunked_assembly():
    def bad_form(b):
        return b.mesh  # not part of the chunk view surface

    jV = fem.Basis(fem.MeshTri(fem.unit_square(n=6)), fem.ElementTri(1, 2))
    with pytest.raises(AttributeError, match="chunked assembly") as ref:
        jV.compiled_solver(bad_form, None, chunk_cells=16)(jnp.zeros((jV.n_dofs, 1)))
    pV = pt.Basis(pt.MeshTri(pt.unit_square(n=6), device="cpu"), pt.ElementTri(1, 2))
    with pytest.raises(AttributeError, match="chunked assembly") as ours:
        pV.compiled_solver(bad_form, None, chunk_cells=16)(
            torch.zeros((pV.n_dofs, 1), dtype=torch.float64)
        )
    assert str(ours.value) == str(ref.value)


def test_non_symmetric_form_with_chunks_raises_as_jax():
    jV = fem.Basis(MeshTet(unit_cube(2)), ElementTet(1, 2))
    with pytest.raises(ValueError, match="chunk_cells requires") as ref:
        jV.compiled_solver(_var_stiffness, _load3, symmetric_form=False, chunk_cells=100)
    V = _port_basis(n=2)
    with pytest.raises(ValueError, match="chunk_cells requires") as ours:
        V.compiled_solver(_var_stiffness, _load3, symmetric_form=False, chunk_cells=100)
    assert str(ours.value) == str(ref.value)
    # chunk_cells=0 keeps the non-symmetric one-shot scatter
    u, info = V.compiled_solver(_var_stiffness, _load3, symmetric_form=False, chunk_cells=0,
                                tol=TOL)()
    assert bool(info.converged) and torch.isfinite(u).all()
