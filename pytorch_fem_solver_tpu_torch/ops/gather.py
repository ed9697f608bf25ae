"""Row gather kernel K6 (counterpart of ``tools/exp_pallas_gather_probe.py``).

The probe tool tries four Pallas formulations of one in-kernel gather
(``k_take``, ``k_taa``, ``k_idx``, ``k_loop``) to see which ones Mosaic
lowers on a TPU. All four compute ``x[cols]`` laid out as ``(nb, B*k)``:
block row ``r`` of the output holds the ``B`` rows of ``x`` that ``cols[r]``
names. On Hopper every formulation is the same load, so one kernel,
``gather_rows`` (``csrc/gather.cu``), is the counterpart of all four. It is
the building block of a gather-fused SpMV (x as ``(n_pad / 8, 8)`` blocks,
``cols`` the BSR column table) and runs on no solver path yet.

``gather_plan`` and ``gather_slot_map`` repeat what the kernel's launcher
and threads compute (which kernel, lanes per slot, slots per thread, and the
words each thread copies), for the CPU test that replays the map.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

#: threads per block of both K6 kernels
THREADS = 256
#: resident threads per SM on Hopper: one wave of the card is SMs x this
WAVE_THREADS = 2048

_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ctypes.c_void_p,
]


def _gather_rows_plain(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: ``x[cols]`` as (nb, B*k)."""
    return x[cols.long()].reshape(cols.shape[0], -1)


def gather_plan(n_slots: int, k: int, itemsize: int, aligned: bool = True,
                wave: int = 132 * WAVE_THREADS) -> dict:
    """The launch K6's launcher picks for ``n_slots`` rows of ``k`` words of
    ``itemsize`` bytes (``aligned``: x on a 16-byte boundary; ``wave``: the
    threads the card holds at once, SMs x ``WAVE_THREADS``).

    ``{"kernel": "vector", "P": lanes per slot (16-byte pieces per row),
    "S": slots per thread, "blocks": ...}`` where a row is 1, 2, 4 or 8
    whole pieces, else ``{"kernel": "any", "P": 1, "S": 1, ...}``: a thread
    per slot, one word at a time.
    """
    per_piece = 16 // itemsize
    pieces = k // per_piece if k % per_piece == 0 else 0
    if pieces in (1, 2, 4, 8) and aligned and n_slots * k < 2**31:
        lanes = n_slots * pieces
        slots = 1 if lanes <= wave else (2 if lanes <= 2 * wave else 4)
        threads = -(-lanes // slots)
        return {"kernel": "vector", "P": pieces, "S": slots, "blocks": -(-threads // THREADS)}
    return {"kernel": "any", "P": 1, "S": 1, "blocks": -(-n_slots // THREADS)}


def gather_slot_map(n_slots: int, k: int, itemsize: int, aligned: bool = True,
                    wave: int = 132 * WAVE_THREADS):
    """Every copy the threads of ``gather_plan``'s launch make, as arrays
    ``(slot, first, words)``: thread ``t`` at step ``s`` copies ``words``
    words of row ``cols[slot]`` of x, from word ``first`` on, to the same
    words of output slot ``slot``; threads past the last slot copy nothing.
    The kernels compute the same expressions."""
    plan = gather_plan(n_slots, k, itemsize, aligned, wave)
    if plan["kernel"] == "any":
        return np.arange(n_slots), np.zeros(n_slots, np.int64), np.full(n_slots, k)
    pieces, per_piece = plan["P"], 16 // itemsize
    t = np.arange(plan["blocks"] * THREADS)
    lane, group = t % pieces, t // pieces
    groups = plan["blocks"] * (THREADS // pieces)
    slot = group[:, None] + np.arange(plan["S"])[None, :] * groups
    first = np.broadcast_to((lane * per_piece)[:, None], slot.shape)
    keep = slot < n_slots
    return slot[keep], first[keep], np.full(int(keep.sum()), per_piece)


def gather_rows(x: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """(n_x, k) rows and (nb, B) int32 row indices -> (nb, B*k).

    CPU tensors take ``_gather_rows_plain``; CUDA tensors launch K6 or
    raise: the vector kernel where a row is 1, 2, 4 or 8 whole 16-byte
    pieces and x lies on a 16-byte boundary, the generic one otherwise (any
    ``k``). Indices must lie in ``[0, n_x)``: the kernels do not check them.
    The output is a copy of ``x[cols]``, bitwise.
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
