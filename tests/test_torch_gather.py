"""PyTorch port, the row gather kernel K6 (``ops/gather.py``), counterpart
of the four probes of ``tools/exp_pallas_gather_probe.py``.

On the probe's own inputs (``default_rng(0)``: x (256, 8) float32, cols
(256, 8) int32) the plain version must equal the tool's NumPy ``want``
exactly, laid out (256, 64) as every probe writes it. The kernel's slot map
(``gather_slot_map``: which thread copies which words of which row), replayed
in NumPy, writes every output word once and equals ``x[cols]`` for k = 1, 3,
8 and 16 at an odd number of block rows, in float32 and float64, with 1, 2
and 4 slots per thread and with x off a 16-byte boundary. The kernel itself
runs only on a card (``cuda`` marker), at the same k.
"""

import numpy as np
import pytest
import torch

from pytorch_fem_solver_tpu_torch.ops import cuda_build
from pytorch_fem_solver_tpu_torch.ops import gather as pg

torch.set_num_threads(1)

NB, K, B = 256, 8, 8  # the tool's nb, k, B


def _probe_inputs():
    """The tool's inputs and expected output, drawn in its order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(NB, K)).astype(np.float32)
    cols = rng.integers(0, NB, size=(NB, B)).astype(np.int32)
    want = x[cols]  # (nb, B, k)
    return x, cols, want.reshape(NB, B * K)


def test_plain_gather_equals_the_probe_want():
    x, cols, want = _probe_inputs()
    out = pg._gather_rows_plain(torch.from_numpy(x), torch.from_numpy(cols))
    assert out.shape == (NB, B * K) and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_wrapper_on_cpu_is_the_plain_version(dtype):
    x, cols, want = _probe_inputs()
    before = dict(cuda_build.launch_counts)
    out = pg.gather_rows(torch.from_numpy(x).to(dtype), torch.from_numpy(cols))
    assert cuda_build.launch_counts == before  # no kernel launched
    np.testing.assert_array_equal(out.numpy(), want.astype(out.numpy().dtype))


def test_non_cpu_non_cuda_tensor_raises():
    x = torch.empty((NB, K), device="meta")
    cols = torch.empty((NB, B), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        pg.gather_rows(x, cols)


EDGE_K = [1, 3, 8, 16]
EDGE_NB, EDGE_B = 37, 5  # odd block rows and slots per row


def _edge_inputs(k, dtype=np.float64):
    rng = np.random.default_rng(k)
    n_x = 41
    x = rng.standard_normal((n_x, k)).astype(dtype)
    cols = rng.integers(0, n_x, size=(EDGE_NB, EDGE_B)).astype(np.int32)
    return x, cols


@pytest.mark.parametrize("aligned,slots_per_thread", [(True, 1), (True, 2), (True, 4), (False, 1)],
                         ids=["S1", "S2", "S4", "off16"])
@pytest.mark.parametrize("itemsize", [4, 8], ids=["f32", "f64"])
@pytest.mark.parametrize("k", EDGE_K)
def test_slot_map_replays_x_cols(k, itemsize, aligned, slots_per_thread):
    x, cols = _edge_inputs(k)
    n_slots = cols.size
    plan = pg.gather_plan(n_slots, k, itemsize, aligned)
    vector = aligned and (k * itemsize) % 16 == 0
    assert plan["kernel"] == ("vector" if vector else "any")
    # a card that holds fewer threads at once makes each take more slots
    lanes = n_slots * plan["P"]
    wave = {1: lanes, 2: lanes - 1, 4: lanes // 2 - 1}[slots_per_thread]
    plan = pg.gather_plan(n_slots, k, itemsize, aligned, wave)
    if vector:
        assert plan["S"] == slots_per_thread and plan["P"] * 16 == k * itemsize
    slot, first, words = pg.gather_slot_map(n_slots, k, itemsize, aligned, wave)
    assert (words == words[0]).all()
    j = np.arange(words[0])
    dst = (slot * k + first)[:, None] + j
    src = (cols.reshape(-1)[slot] * k + first)[:, None] + j
    assert (first + words <= k).all()
    written = np.bincount(dst.reshape(-1), minlength=n_slots * k)
    assert (written == 1).all()  # every output word, once
    out = np.empty(n_slots * k)
    out[dst] = x.reshape(-1)[src]
    np.testing.assert_array_equal(out.reshape(EDGE_NB, EDGE_B * k), x[cols].reshape(EDGE_NB, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "off16"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("k", EDGE_K)
def test_k6_edge_k_equals_x_cols_on_card(k, dtype, misaligned):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is a CUDA kernel with no CPU mode")
    x, cols = _edge_inputs(k)
    xd = torch.from_numpy(x).to("cuda", dtype)
    if misaligned:
        xd = cuda_build.misaligned_copy(xd)
    cd = torch.from_numpy(cols).cuda()
    out = pg.gather_rows(xd, cd)
    torch.cuda.synchronize()
    assert torch.equal(out, xd[cd.long()].reshape(EDGE_NB, -1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k6_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K6 is a CUDA kernel with no CPU mode")
    x, cols, want = _probe_inputs()
    xd = torch.from_numpy(x).to("cuda", dtype)
    cd = torch.from_numpy(cols).cuda()
    before = cuda_build.launch_counts["gather_rows"]
    out = pg.gather_rows(xd, cd)
    torch.cuda.synchronize()
    assert cuda_build.launch_counts["gather_rows"] == before + 1
    assert torch.equal(out, pg._gather_rows_plain(xd, cd))
    np.testing.assert_array_equal(out.cpu().numpy(), want.astype(out.cpu().numpy().dtype))
