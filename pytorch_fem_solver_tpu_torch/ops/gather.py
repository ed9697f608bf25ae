"""Row gather kernel K6 (counterpart of ``tools/exp_pallas_gather_probe.py``).

The probe tool tries four Pallas formulations of one in-kernel gather
(``k_take``, ``k_taa``, ``k_idx``, ``k_loop``) to see which ones Mosaic
lowers on a TPU. All four compute ``x[cols]`` laid out as ``(nb, B*k)``:
block row ``r`` of the output holds the ``B`` rows of ``x`` that ``cols[r]``
names. On Hopper every formulation is the same load, so one kernel,
``gather_rows`` (``csrc/gather.cu``), is the counterpart of all four. It is
the building block of a gather-fused SpMV (x as ``(n_pad / 8, 8)`` blocks,
``cols`` the BSR column table) and runs on no solver path yet.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p,
]


def _gather_rows_plain(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``x[cols]`` as (nb, B*k)."""
    return x[cols.long()].reshape(cols.shape[0], -1)


def gather_rows(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(n_x, k) rows and (nb, B) int32 row indices -> (nb, B*k).

    CPU tensors take ``_gather_rows_plain``; CUDA tensors launch K6 or
    raise. Indices must lie in ``[0, n_x)``: the kernel does not check them.
    """
    if x.device.type == "cpu":
        return _gather_rows_plain(x, cols)
    n_x, k = x.shape
    nb, B = cols.shape
    cuda_build.check(x, "x", (n_x, k), x.dtype)
    cuda_build.check(cols, "cols", (nb, B), torch.int32)
    out = torch.empty((nb, B * k), dtype=x.dtype, device=x.device)
    fn = cuda_build.function("gather", "gather_rows", x.dtype, _ARGTYPES)
    err = fn(
        x.data_ptr(), cols.data_ptr(), out.data_ptr(), nb * B, k,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "gather_rows")
    cuda_build.launch_counts["gather_rows"] += 1
    return out
