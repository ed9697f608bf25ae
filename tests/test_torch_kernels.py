"""PyTorch port, kernels K1 (P1 element kernel for embedded triangles) and
K5 (the 2D P1 element kernel with a per-cell scale).

On the CPU the wrappers run the plain versions, which must equal the JAX
package's XLA oracles (``_p1_xla_3d``, ``_p1_xla``) and its Pallas kernels
run in interpret mode to 1e-14 on the same SoA input, padding lanes
included, on the h=0.25 DFN (K1), a unit square (K5) and on seeded
triangles at T = 1, 255, 257 and 1,001 (sizes that leave a tail block whose
words do not fill whole 16-byte pieces), K5 with and without a scale. The
maps by which both kernels read their staged coordinates back from shared
memory are held free of bank conflicts in float32 and float64. The kernels
themselves run only on a card (``cuda`` marker); ``chip_smoke.py`` holds
them against the plain versions at the benchmark size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu as fem
import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu.ops import pallas_kernels as jk
from pytorch_fem_solver_tpu.utils import build_benchmark_network as jax_network
from pytorch_fem_solver_tpu_torch import config, interop
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import kernels as pk

torch.set_num_threads(1)
config.set_default_dtype(torch.float64)


@pytest.fixture(scope="module")
def network():
    jm = jax_network(h=0.25)
    pm = interop.mesh_from_numpy(
        jax.tree_util.tree_map(np.asarray, jm._t), device="cpu"
    )
    return jm, pm


def _rel(ours, ref):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_soa_layout_matches_jax(network):
    jm, pm = network
    soa = pk.coords_to_soa_3d(pm["cells", "coordinates_3d"])
    ref = jk.coords_to_soa_3d(jm["cells", "coordinates_3d"])
    np.testing.assert_array_equal(soa.numpy(), np.asarray(ref))


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_k1_matches_jax_kernel(network, oracle):
    jm, pm = network
    jsoa = jk.coords_to_soa_3d(jm["cells", "coordinates_3d"])
    if oracle == "xla":
        ref = jk._p1_xla_3d(jsoa)
    else:
        ref = jk._p1_pallas_3d(jsoa, interpret=True)
    ref = np.asarray(ref)
    ours = pk._p1_plain_3d(pk.coords_to_soa_3d(pm["cells", "coordinates_3d"]))
    assert ours.shape == (pk.P1_OUT_ROWS, ref.shape[1])
    assert _rel(ours.numpy(), ref[: pk.P1_OUT_ROWS]) <= 1e-14
    assert not ref[pk.P1_OUT_ROWS :].any()  # the TPU's zero pad rows


K1_SIZES = [1, 255, 257, 1001]


def _seeded_cells(T, device="cpu", dtype=torch.float64):
    """(T, 3, 3) seeded triangles in space, none degenerate."""
    rng = np.random.default_rng(T)
    coords = rng.uniform(-1.0, 1.0, size=(T, 3, 3))
    coords[:, 1] += 2.0  # keep the three vertices apart
    coords[:, 2, 1] -= 3.0
    return torch.as_tensor(coords, dtype=dtype, device=device)


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("T", K1_SIZES)
def test_plain_k1_matches_jax_kernel_at_edge_sizes(T, oracle):
    coords = _seeded_cells(T)
    jsoa = jk.coords_to_soa_3d(jnp.asarray(coords.numpy()))
    ref = np.asarray(
        jk._p1_xla_3d(jsoa) if oracle == "xla" else jk._p1_pallas_3d(jsoa, interpret=True)
    )
    ours = pk.p1_element_3d(coords)  # the wrapper on the (T, 3, 3) layout
    assert ours.shape == (pk.P1_OUT_ROWS, T)
    assert bool((ours[12] > 0).all())
    assert _rel(ours.numpy(), ref[: pk.P1_OUT_ROWS, :T]) <= 1e-14


def _bank_conflicts(offsets, word_bytes, words_per_read=1):
    """Largest number of reads of one shared-memory phase (the threads whose
    reads of ``words_per_read`` words add up to 128 bytes) that meet in one
    4-byte bank, over all steps."""
    read_bytes = word_bytes * words_per_read
    per_phase = 128 // read_bytes
    worst = 0
    for step in range(offsets.shape[1]):
        for first in range(0, offsets.shape[0], per_phase):
            start = offsets[first:first + per_phase, step] * word_bytes
            banks = (start[:, None] + np.arange(0, read_bytes, 4)[None, :]) // 4 % 32
            worst = max(worst, np.bincount(banks.reshape(-1), minlength=32).max())
    return worst


@pytest.mark.parametrize("word_bytes", [4, 8], ids=["f32", "f64"])
def test_k1_staged_reads_cover_the_tile_without_bank_conflicts(word_bytes):
    threads, words = 128, 9
    off = pk.staged_word_offsets(threads, words)
    assert off.shape == (threads, words)
    # every word of the tile is read once, by the thread whose cell holds it
    np.testing.assert_array_equal(np.sort(off.reshape(-1)), np.arange(threads * words))
    assert (off // words == np.arange(threads)[:, None]).all()
    assert _bank_conflicts(off, word_bytes) == 1
    # 9 is odd; an even cell size (the 2D kernel's 6 words) would collide
    assert _bank_conflicts(pk.staged_word_offsets(threads, 6), word_bytes) > 1


def test_wrapper_on_cpu_is_the_plain_version(network):
    _, pm = network
    coords = pm["cells", "coordinates_3d"]
    before = dict(cuda_build.launch_counts)
    out = pk.p1_element_3d(coords)
    assert cuda_build.launch_counts == before  # no kernel launched
    T = pm.n_cells
    assert torch.equal(out, pk._p1_plain_3d(coords.reshape(T, 9).T))


def test_public_api_matches_jax(network):
    jm, pm = network
    ours = pk.p1_local_stiffness_load_3d(pm["cells", "coordinates_3d"])
    ref = jk.p1_local_stiffness_load_3d(
        jm["cells", "coordinates_3d"], use_pallas=False
    )
    for a, b in zip(ours, ref):
        assert _rel(a.numpy(), b) <= 1e-14


def test_k1_equals_tangential_assembly(network):
    """The identity the JAX package asserts, held by the port: K1 rows ==
    the basis's tangential-gradient stiffness and f=1 load."""
    _, pm = network
    V = pt.FractureNetworkBasis(pm, pt.ElementTri(1, 2))
    stiff, load, areas = pk.p1_local_stiffness_load_3d(pm["cells", "coordinates_3d"])
    ref = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    assert _rel(stiff.numpy(), ref.numpy()) <= 1e-12
    ref_load = V.integrate_linear_form_local(lambda b: b.v)[..., 0]
    assert _rel(load.numpy(), ref_load.numpy()) <= 1e-12
    assert abs(float(areas.sum()) - float(V._dx.sum())) <= 1e-12 * float(areas.sum())


def test_2d_coordinates_are_lifted_with_zero_z():
    tri = fem.unit_square(n=4)
    mesh = pt.MeshTri(tri, device="cpu")
    stiff, load, areas = pk.p1_local_stiffness_load_3d(mesh["cells", "coordinates"])
    ref_stiff, ref_load, _ = jk.p1_local_stiffness_load(
        jnp.asarray(np.asarray(mesh["cells", "coordinates"])), use_pallas=False
    )
    assert _rel(stiff.numpy(), ref_stiff) <= 1e-13
    assert _rel(load.numpy(), ref_load) <= 1e-14
    assert abs(float(areas.sum()) - 1.0) < 1e-12


def test_non_cpu_non_cuda_tensor_raises_instead_of_falling_back():
    coords = torch.empty((4, 3, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pk.p1_element_3d(coords)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_kernel_matches_plain_on_card(network, dtype, tol):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
    _, pm = network
    coords = pm["cells", "coordinates_3d"].to("cuda", dtype).contiguous()
    before = cuda_build.launch_counts["p1_element_3d"]
    out = pk.p1_element_3d(coords)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["p1_element_3d"] == before + 1
    ref = pk._p1_plain_3d(coords.reshape(-1, 9).T)
    err = ((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max()
    assert float(err) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "off16"])
@pytest.mark.parametrize("T", K1_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_edge_sizes_match_plain_on_card(dtype, tol, T, misaligned):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 is a CUDA kernel with no CPU mode")
    coords = _seeded_cells(T, device="cuda", dtype=dtype)
    if misaligned:
        coords = cuda_build.misaligned_copy(coords)
    out = pk.p1_element_3d(coords)
    again = pk.p1_element_3d(coords)
    torch.cuda.synchronize()
    ref = pk._p1_plain_3d(coords.reshape(T, 9).T)
    err = ((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max()
    assert float(err) <= tol
    assert torch.equal(out, again)  # bitwise repeatable


# -- K5: the 2D P1 element kernel ---------------------------------------------


@pytest.fixture(scope="module")
def square():
    """unit_square(n=7) cells, a seeded scale, and one clockwise cell."""
    tri = fem.unit_square(n=7)
    coords = np.asarray(tri["vertices"])[np.asarray(tri["triangles"])]
    coords[5] = coords[5][[0, 2, 1]]  # clockwise: negative det and area
    scale = np.random.default_rng(0).uniform(0.5, 2.0, size=coords.shape[0])
    return coords, scale


@pytest.mark.parametrize("with_scale", [False, True])
def test_soa_layout_matches_jax_2d(square, with_scale):
    coords, scale = square
    s = scale if with_scale else None
    ours = pk.coords_to_soa(torch.tensor(coords), None if s is None else torch.tensor(s))
    ref = jk.coords_to_soa(jnp.asarray(coords), None if s is None else jnp.asarray(s))
    assert ours.dtype == torch.float64
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
def test_plain_k5_matches_jax_kernel(square, oracle):
    coords, scale = square
    jsoa = jk.coords_to_soa(jnp.asarray(coords), jnp.asarray(scale))
    ref = np.asarray(jk._p1_xla(jsoa) if oracle == "xla" else jk._p1_pallas(jsoa, interpret=True))
    ours = pk._p1_plain(pk.coords_to_soa(torch.tensor(coords), torch.tensor(scale)))
    # padding lanes included: the unit triangle with scale 0
    assert ours.shape == (pk.P1_OUT_ROWS_2D, ref.shape[1]) and ref.shape[1] > coords.shape[0]
    assert _rel(ours.numpy(), ref[: pk.P1_OUT_ROWS_2D]) <= 1e-14
    assert not ref[pk.P1_OUT_ROWS_2D :].any()  # the TPU's zero pad rows
    assert ours[12, 5] < 0 and ours[13, 5] < 0  # signed det, as on the TPU


@pytest.mark.parametrize("with_scale", [False, True])
def test_public_api_2d_matches_jax_and_generic_assembly(with_scale):
    tri = fem.unit_square(n=7)
    mesh = pt.MeshTri(tri, device="cpu")
    V = pt.Basis(mesh, pt.ElementTri(1, 2))
    coords = mesh["cells", "coordinates"]
    scale = np.full(mesh.n_cells, 2.5) if with_scale else None
    ours = pk.p1_local_stiffness_load(coords, None if scale is None else torch.tensor(scale))
    ref = jk.p1_local_stiffness_load(
        jnp.asarray(coords.numpy()), None if scale is None else jnp.asarray(scale),
        use_pallas=False,
    )
    for a, b in zip(ours, ref):
        assert _rel(a.numpy(), b) <= 1e-14
    factor = 2.5 if with_scale else 1.0
    stiff_ref = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    load_ref = V.integrate_linear_form_local(lambda b: b.v)[..., 0]
    np.testing.assert_allclose(ours[0].numpy(), factor * stiff_ref.numpy(), atol=1e-13)
    np.testing.assert_allclose(ours[1].numpy(), factor * load_ref.numpy(), atol=1e-13)
    assert abs(float(ours[2].sum()) - factor) < 1e-12


def test_k5_wrapper_on_cpu_is_the_plain_version(square):
    coords, scale = square
    c, s = torch.tensor(coords), torch.tensor(scale)
    before = dict(cuda_build.launch_counts)
    out = pk.p1_element_2d(c, s)
    assert cuda_build.launch_counts == before  # no kernel launched
    assert torch.equal(out, pk._p1_plain(pk._soa_rows(c, s)))
    assert torch.equal(pk._soa_rows(c, s), pk.coords_to_soa(c, s)[:7, : c.shape[0]])


def test_k5_on_non_cpu_non_cuda_tensor_raises():
    coords = torch.empty((4, 3, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pk.p1_element_2d(coords)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
@pytest.mark.parametrize("with_scale", [False, True])
def test_k5_kernel_matches_plain_on_card(square, dtype, tol, with_scale):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 is a CUDA kernel with no CPU mode")
    coords, scale = square
    c = torch.tensor(coords).to("cuda", dtype)
    s = torch.tensor(scale).to("cuda", dtype) if with_scale else None
    before = cuda_build.launch_counts["p1_element_2d"]
    out = pk.p1_element_2d(c, s)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["p1_element_2d"] == before + 1
    ref = pk._p1_plain(pk._soa_rows(c, s))
    err = ((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max()
    assert float(err) <= tol


def _seeded_cells_2d(T, device="cpu", dtype=torch.float64):
    """(T, 3, 2) seeded planar triangles, none degenerate (|det| >= 0.8),
    every third one clockwise, and a seeded (T,) scale."""
    rng = np.random.default_rng(T)
    coords = rng.uniform(-0.4, 0.4, size=(T, 3, 2))
    coords[:, 1, 0] += 2.0
    coords[:, 2, 1] += 2.0
    coords[::3] = coords[::3, [0, 2, 1]]
    scale = rng.uniform(0.5, 1.5, size=T)
    return (
        torch.as_tensor(coords, dtype=dtype, device=device),
        torch.as_tensor(scale, dtype=dtype, device=device),
    )


@pytest.mark.parametrize("oracle", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("with_scale", [False, True], ids=["scale1", "scaled"])
@pytest.mark.parametrize("T", K1_SIZES)
def test_plain_k5_matches_jax_kernel_at_edge_sizes(T, with_scale, oracle):
    coords, scale = _seeded_cells_2d(T)
    s = scale if with_scale else None
    jsoa = jk.coords_to_soa(
        jnp.asarray(coords.numpy()), None if s is None else jnp.asarray(s.numpy())
    )
    ref = np.asarray(jk._p1_xla(jsoa) if oracle == "xla" else jk._p1_pallas(jsoa, interpret=True))
    ours = pk.p1_element_2d(coords, s)  # the wrapper on the (T, 3, 2) layout
    assert ours.shape == (pk.P1_OUT_ROWS_2D, T)
    assert bool((ours[13, ::3] < 0).all()) and bool((ours[13, 1::3] > 0).all())
    assert _rel(ours.numpy(), ref[: pk.P1_OUT_ROWS_2D, :T]) <= 1e-14


@pytest.mark.parametrize("word_bytes", [4, 8], ids=["f32", "f64"])
def test_k5_staged_reads_cover_the_tile_without_bank_conflicts(word_bytes):
    threads, words, per_read = 128, 6, 2
    off = pk.staged_word_offsets(threads, words, per_read)
    assert off.shape == (threads, words // per_read)
    # every word of the tile is read once, by the thread whose cell holds it
    covered = (off[:, :, None] + np.arange(per_read)).reshape(-1)
    np.testing.assert_array_equal(np.sort(covered), np.arange(threads * words))
    assert (off // words == np.arange(threads)[:, None]).all()
    # pieces of 2 words: 8 bytes in f32, 16 in f64, each on its own boundary
    assert (off * word_bytes % (per_read * word_bytes) == 0).all()
    assert _bank_conflicts(off, word_bytes, per_read) == 1
    # read back one word at a time, the even stride of 6 would collide
    assert _bank_conflicts(pk.staged_word_offsets(threads, words), word_bytes) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "off16"])
@pytest.mark.parametrize("with_scale", [False, True], ids=["scale1", "scaled"])
@pytest.mark.parametrize("T", K1_SIZES)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k5_edge_sizes_match_plain_on_card(dtype, tol, T, with_scale, misaligned):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K5 is a CUDA kernel with no CPU mode")
    coords, scale = _seeded_cells_2d(T, device="cuda", dtype=dtype)
    if misaligned:
        coords = cuda_build.misaligned_copy(coords)
    s = scale if with_scale else None
    out = pk.p1_element_2d(coords, s)
    again = pk.p1_element_2d(coords, s)
    torch.cuda.synchronize()
    ref = pk._p1_plain(pk._soa_rows(coords, s))
    err = ((out - ref).abs().amax(dim=1) / ref.abs().amax(dim=1)).max()
    assert float(err) <= tol
    assert torch.equal(out, again)  # bitwise repeatable
