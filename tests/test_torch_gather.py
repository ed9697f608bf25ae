"""PyTorch port, the row gather kernel K6 (``ops/gather.py``), counterpart
of the four probes of ``tools/exp_pallas_gather_probe.py``.

On the probe's own inputs (``default_rng(0)``: x (256, 8) float32, cols
(256, 8) int32) the plain version must equal the tool's NumPy ``want``
exactly, laid out (256, 64) as every probe writes it. The kernel itself runs
only on a card (``cuda`` marker).
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
