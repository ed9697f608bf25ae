"""PyTorch port, the batched small inverse K7 (``csrc/small_inv.cu``),
behind ``ops/precondition.py:batched_small_inv``.

On the CPU the wrapper is the plain loop (``_batched_small_inv_plain``,
held to the JAX package in ``tests/test_torch_bsr.py``), and the kernel's
in-place elimination (the row and column of pivot k zeroed, their copies
patched with 1 and -1, one fused update for every word; matrices padded with
the identity to the next of 8, 16, 32, 64 and 128) is replayed in NumPy:
it equals the plain loop to roundoff and leaves the padding the identity
(above n = 128 K7 keeps the n x n block in shared memory, unpadded). The
wrapper refuses bf16, n above what one CTA's shared memory holds (239 in
float32, 168 in float64) and a tensor on no card, before any launch.

On a card (``cuda`` marker) K7 is held against the plain loop: seeded SPD
batches of 37 matrices (no multiple of the 16, 4 or 1 matrices a warp holds,
nor of a CTA's 128, 32 or 8) with an all-zero block pinned to the identity,
at n = 8, 16, 32, 64, 128 and at 5, 24, 40, 100 (padded; 5 and 100 through
the one-word loads), and through the shared-memory kernel at n = 129, 160,
192, 224, 239 in float32 and 129, 160, 168 in float64 (the sharded
aggregate-block smoother's gs of 160, 192 and 224 among them); the 8 x 8 diagonal blocks (padding rows pinned) and
the 64 x 64 aggregate blocks of a P1 stiffness on ``unit_cube(16)`` with a
log-normal kappa per cell. Float64 within 1e-12 relative (Frobenius, each
matrix): the same elimination, rounded in another order. Float32 within
twice the plain loop's own error against the float64 inverse plus n
float32 ulps: the kernel rounds a multiply and a subtract once (FMA) and
multiplies by 1 / p where the loop divides by p, so its error may fall
anywhere within the loop's, plus one rounding of each of a word's n
updates. The output is contiguous, each call one launch, and
``agg_block_two_level_from_values`` on the card exactly one.
"""

import numpy as np
import pytest
import torch

import pytorch_fem_solver_tpu_torch as pt
from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import precondition as pp
from pytorch_fem_solver_tpu_torch.ops.bsr import (
    bsr_diagonal,
    bsr_values_from_local_symmetric,
    get_bsr_structure,
)

torch.set_num_threads(1)

CARD_N = [8, 16, 32, 64, 128]
EDGE_N = [5, 24, 40, 100]
SHARED_CASES = [(129, torch.float32), (160, torch.float32), (192, torch.float32),
                (224, torch.float32), (239, torch.float32), (129, torch.float64),
                (160, torch.float64), (168, torch.float64)]
BATCH = 37
ZERO_BLOCK = 3  # the all-zero block of each seeded batch, pinned to I
EPS32 = float(np.finfo(np.float32).eps)
CUBE_N = 16
GS = 64
SKIP = "needs an NVIDIA GPU: K7 is a CUDA kernel with no CPU mode"


def _padded_size(n):
    if n > 128:  # the shared-memory kernel: no padding
        return n
    size = 8
    while size < n:
        size *= 2
    return size


def _inplace_replay(a: np.ndarray):
    """K7's elimination on the whole padded matrix (or, above n = 128, the
n x n block), in float64 NumPy:
    returns the (..., n, n) inverse and the padded store."""
    n = a.shape[-1]
    size = _padded_size(n)
    m = np.broadcast_to(np.eye(size), a.shape[:-2] + (size, size)).copy()
    m[..., :n, :n] = a
    for k in range(size):
        p = m[..., k, k].copy()
        row = m[..., k, :].copy()
        row[..., k] = 1.0
        col = m[..., :, k].copy()
        col[..., k] = -1.0
        m[..., k, :] = 0.0
        m[..., :, k] = 0.0
        r = 1.0 / p
        m -= col[..., :, None] * (row * r[..., None])[..., None, :]
    return m[..., :n, :n], m


def _spd_batch(n, seed=0):
    """BATCH seeded SPD (n, n) blocks, block ZERO_BLOCK all-zero then pinned
    to the identity, as ``_pin_zero_diagonal`` does for padding rows."""
    rng = np.random.default_rng(seed + n)
    m = rng.standard_normal((BATCH, n, n))
    spd = m @ m.transpose(0, 2, 1) + n * np.eye(n)
    spd[ZERO_BLOCK] = 0.0
    return pp._pin_zero_diagonal(torch.from_numpy(spd))


def _rel(ours: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest relative Frobenius distance over the batch."""
    ours, ref = ours.double().cpu(), ref.double().cpu()
    return float(
        (torch.linalg.matrix_norm(ours - ref) / torch.linalg.matrix_norm(ref)).max()
    )


@pytest.mark.parametrize("n", [1, 3, 5, 8, 13, 24, 40, 64, 100, 160])
def test_inplace_replay_matches_plain_and_keeps_padding(n):
    a = _spd_batch(n).numpy()
    inv, store = _inplace_replay(a)
    plain = pp._batched_small_inv_plain(torch.from_numpy(a))
    assert _rel(torch.from_numpy(inv), plain) <= 1e-14
    assert np.array_equal(inv[ZERO_BLOCK], np.eye(n))
    size = store.shape[-1]
    pad = np.broadcast_to(np.eye(size - n), (BATCH, size - n, size - n))
    np.testing.assert_array_equal(store[..., n:, n:], pad)
    assert not store[..., :n, n:].any() and not store[..., n:, :n].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    a = _spd_batch(8).to(dtype)
    before = dict(cuda_build.launch_counts)
    out = pp.batched_small_inv(a)
    assert cuda_build.launch_counts == before  # no kernel launched
    assert torch.equal(out, pp._batched_small_inv_plain(a))


@pytest.mark.parametrize(
    "shape,dtype,error,match",
    [
        ((4, 8, 8), torch.bfloat16, TypeError, "float32 or float64"),
        ((1, 256, 256), torch.float32, ValueError, "n = 256 > 239"),
        ((4, 8, 6), torch.float32, ValueError, r"\(\.\.\., n, n\)"),
        ((4, 8, 8), torch.float32, ValueError, "CUDA tensor"),
        ((1, 240, 240), torch.float32, ValueError, "n = 240 > 239"),
        ((1, 169, 169), torch.float64, ValueError, "n = 169 > 168"),
        ((1, 239, 239), torch.float32, ValueError, "CUDA tensor"),
        ((1, 168, 168), torch.float64, ValueError, "CUDA tensor"),
    ],
    ids=["bf16", "n256", "not_square", "meta", "f32_n240", "f64_n169", "f32_n239_fits",
         "f64_n168_fits"],
)
def test_wrapper_refuses_before_any_launch(shape, dtype, error, match):
    before = dict(cuda_build.launch_counts)
    with pytest.raises(error, match=match):
        pp.batched_small_inv(torch.empty(shape, dtype=dtype, device="meta"))
    assert cuda_build.launch_counts == before


@pytest.mark.parametrize(
    "dtype,max_n", [(torch.float32, 239), (torch.float64, 168)], ids=["f32", "f64"]
)
def test_largest_n_fills_one_cta_of_shared_memory(dtype, max_n):
    size = torch.empty((), dtype=dtype).element_size()
    assert pp.small_inv_max_n(dtype) == max_n
    assert (max_n**2 + 4 * max_n) * size <= pp.SMALL_INV_SHARED_BYTES
    assert ((max_n + 1) ** 2 + 4 * (max_n + 1)) * size > pp.SMALL_INV_SHARED_BYTES


def _card():
    if not torch.cuda.is_available():
        pytest.skip(SKIP)
    return torch.device("cuda")


def _held(a, out, plain, dtype):
    """Hold K7's ``out`` against the plain loop's ``plain`` on the batch
    ``a`` (the module docstring's tolerances)."""
    assert out.shape == a.shape and out.dtype == dtype and out.is_contiguous()
    n = a.shape[-1]
    if dtype == torch.float64:
        assert _rel(out, plain) <= 1e-12
    else:
        truth = pp._batched_small_inv_plain(a.double())
        assert _rel(out, truth) <= 2 * _rel(plain, truth) + n * EPS32


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", CARD_N + EDGE_N)
def test_k7_matches_plain_on_card(n, dtype):
    _matches_plain_on_card(n, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,dtype", SHARED_CASES, ids=[f"{str(d)[6:]}-{n}" for n, d in SHARED_CASES]
)
def test_k7_shared_matches_plain_on_card(n, dtype):
    _matches_plain_on_card(n, dtype)


def _matches_plain_on_card(n, dtype):
    dev = _card()
    a = _spd_batch(n).to(dev, dtype)
    before = cuda_build.launch_counts["small_inv"]
    out = pp.batched_small_inv(a)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["small_inv"] == before + 1
    _held(a, out, pp._batched_small_inv_plain(a), dtype)
    assert torch.equal(out[ZERO_BLOCK].cpu(), torch.eye(n, dtype=dtype))  # exact
    assert torch.equal(pp.batched_small_inv(a), out)  # repeatable, bitwise
    # leading batch dimensions, and an empty batch (no launch)
    a2 = a[:36].reshape(6, 6, n, n)
    assert torch.equal(pp.batched_small_inv(a2), out[:36].reshape(6, 6, n, n))
    before = cuda_build.launch_counts["small_inv"]
    assert pp.batched_small_inv(a[:0]).shape == (0, n, n)
    assert cuda_build.launch_counts["small_inv"] == before


def _stiffness(dev, dtype):
    """P1 stiffness of unit_cube(CUBE_N) with a log-normal kappa per cell
    (sigma 1): its BSR structure and values."""
    mesh = pt.MeshTet(pt.unit_cube(CUBE_N), device=dev, dtype=torch.float64)
    V = pt.Basis(mesh, pt.ElementTet(1, 2))
    st = get_bsr_structure(V, max_b=8, want_entry_slot=False)
    kappa = np.exp(np.random.default_rng(11).standard_normal(mesh.n_cells))
    local = V.integrate_bilinear_form_local(lambda b: b.v_grad @ b.v_grad.mT)
    local = local * torch.from_numpy(kappa).to(dev).reshape(-1, 1, 1)
    v1, v2 = bsr_values_from_local_symmetric(st, local)
    return st, (v1.to(dtype), v2.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k7_on_stiffness_blocks_on_card(dtype, monkeypatch):
    dev = _card()
    st, values = _stiffness(dev, dtype)
    # the 8 x 8 block-Jacobi blocks, padding rows' all-zero blocks pinned
    d8 = values[0][:, 0]
    assert bool((torch.diagonal(d8, dim1=-2, dim2=-1) == 0).all(-1).any())
    d8 = pp._pin_zero_diagonal(d8)
    _held(d8, pp.batched_small_inv(d8), pp._batched_small_inv_plain(d8), dtype)
    # the aggregate-block M: its (ns, 64, 64) blocks through one launch
    seen = []
    kernel = pp.batched_small_inv
    monkeypatch.setattr(pp, "batched_small_inv", lambda a: seen.append(a) or kernel(a))
    before = cuda_build.launch_counts["small_inv"]
    M = pp.agg_block_two_level_from_values(
        st, values, bsr_diagonal(st, values), g=GS, gs=GS
    )
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["small_inv"] == before + 1
    assert len(seen) == 1 and seen[0].shape == (st.n_pad // GS, GS, GS)
    assert M.inv_agg.is_contiguous()
    _held(seen[0], M.inv_agg, pp._batched_small_inv_plain(seen[0]), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape,dtype,error",
    [
        ((4, 8, 8), torch.bfloat16, TypeError),
        ((1, 256, 256), torch.float32, ValueError),
        ((1, 240, 240), torch.float32, ValueError),
        ((1, 169, 169), torch.float64, ValueError),
    ],
    ids=["bf16", "n256", "f32_n240", "f64_n169"],
)
def test_k7_refuses_on_card(shape, dtype, error):
    dev = _card()
    before = cuda_build.launch_counts["small_inv"]
    with pytest.raises(error):
        pp.batched_small_inv(torch.eye(shape[-1], dtype=dtype, device=dev).expand(shape))
    assert cuda_build.launch_counts["small_inv"] == before
