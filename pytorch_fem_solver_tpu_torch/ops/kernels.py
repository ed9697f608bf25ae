"""P1 element kernels (counterpart of
``pytorch_fem_solver_tpu/ops/pallas_kernels.py``).

Kernel K1 (``csrc/p1_element.cu``) computes, per triangle of a fracture
network, the intrinsic P1 stiffness S_ij = (e_i . e_j) / (4A), the f=1 load
A/3 and the area A from the lifted 3D vertex coordinates. It is the port of
the Pallas ``_p1_kernel_3d``; the JAX package asserts that this equals the
tangential-gradient assembly of ``FractureNetworkBasis`` to roundoff.

Layouts: the kernel reads the mesh's (T, 3, 3) coordinates as they are and
writes (13, T) rows (``P1_OUT_ROWS``): 0-8 the row-major stiffness, 9-11 the
load, 12 the area. ``p1_local_stiffness_load_3d`` returns what the JAX
function of that name returns. ``_p1_plain_3d`` is the plain PyTorch
version, written on SoA rows like the Pallas kernel body, so it runs on the
kernel's input and on the TPU's padded (16, T_pad) layout alike.

Kernel K5 (same source) is the port of the 2D Pallas ``_p1_kernel``: the P1
stiffness, load, area and signed ``det`` of planar cells with an optional
per-cell scale, from the mesh's (T, 3, 2) coordinates, written as (14, T)
rows (``P1_OUT_ROWS_2D``). ``_p1_plain`` is its plain version on SoA rows
(x0 y0 x1 y1 x2 y2 scale), the counterpart of the JAX ``_p1_xla``;
``coords_to_soa`` builds the TPU's padded (8, T_pad) input for parity
checks only. ``p1_local_stiffness_load`` returns what the JAX function of
that name returns. The arithmetic is the TPU kernel's: ``det`` keeps its
sign (a clockwise cell gives a negative area and stiffness) and ``scale``
multiplies the stiffness as well as the load.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_build

#: output rows of K1: 9 stiffness, 3 load, area
P1_OUT_ROWS = 13
#: 3D SoA input rows of the TPU layout: x0 y0 z0 x1 y1 z1 x2 y2 z2 + 7 pad
IN_ROWS_3D = 16
#: the TPU kernel's lane block (the SoA padding unit of ``coords_to_soa_3d``)
LANE_BLOCK = 2048
#: output rows of K5: 9 stiffness, 3 load, area, det
P1_OUT_ROWS_2D = 14
#: 2D SoA input rows of the TPU layout: x0 y0 x1 y1 x2 y2 scale pad
IN_ROWS = 8

_P1_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
_P1_2D_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
]


def _p1_plain_3d(soa: torch.Tensor) -> torch.Tensor:
    """Plain version of K1 on SoA rows (rows 0-8: x0 y0 z0 ... z2).

    The elementwise formula of the Pallas ``_p1_kernel_3d``; returns the
    (13, T) output rows.
    """
    p = [(soa[3 * i], soa[3 * i + 1], soa[3 * i + 2]) for i in range(3)]

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1], a[2] - b[2])

    def dot3(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    e0 = sub(p[2], p[1])  # opposite vertex 0
    e1 = sub(p[0], p[2])  # opposite vertex 1
    e2 = sub(p[1], p[0])  # opposite vertex 2

    # area from the cross product of two edges
    u, v = e2, sub(p[2], p[0])
    cx = u[1] * v[2] - u[2] * v[1]
    cy = u[2] * v[0] - u[0] * v[2]
    cz = u[0] * v[1] - u[1] * v[0]
    area = 0.5 * torch.sqrt(cx * cx + cy * cy + cz * cz)
    inv4a = 0.25 / area

    s00 = dot3(e0, e0) * inv4a
    s01 = dot3(e0, e1) * inv4a
    s02 = dot3(e0, e2) * inv4a
    s11 = dot3(e1, e1) * inv4a
    s12 = dot3(e1, e2) * inv4a
    s22 = dot3(e2, e2) * inv4a
    load = area * (1.0 / 3.0)
    return torch.stack(
        [s00, s01, s02, s01, s11, s12, s02, s12, s22, load, load, load, area]
    )


def staged_word_offsets(threads: int, words_per_cell: int = 9, words_per_read: int = 1):
    """Word offsets, in a thread block's shared-memory tile, of the reads
    with which K1's and K5's threads take back their staged coordinates.

    The tile holds the block's cells as they lie in memory,
    ``words_per_cell`` words each, and thread ``t`` owns cell ``t``, which it
    reads ``words_per_read`` words at a time (K1: 9 and 1; K5: 6 and 2, 8
    bytes in float32 and 16 in float64). Returns the ``(threads,
    words_per_cell // words_per_read)`` offsets of the first word of each
    read; row ``t``, column ``m`` is the read thread ``t`` makes at step
    ``m``. The kernels compute the same expression; this copy is for the
    test that a warp's reads are free of bank conflicts.
    """
    steps = np.arange(0, words_per_cell, words_per_read)
    return np.arange(threads)[:, None] * words_per_cell + steps[None, :]


def p1_element_3d(cell_coords3d: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) lifted cell coordinates -> (13, T) K1 output rows.

    CPU tensors take ``_p1_plain_3d``; CUDA tensors launch K1 or raise.
    """
    T = cell_coords3d.shape[0]
    if cell_coords3d.device.type == "cpu":
        return _p1_plain_3d(cell_coords3d.reshape(T, 9).T)
    cuda_build.check(cell_coords3d, "cell_coords3d", (T, 3, 3), cell_coords3d.dtype)
    out = torch.empty(
        (P1_OUT_ROWS, T), dtype=cell_coords3d.dtype, device=cell_coords3d.device
    )
    fn = cuda_build.function(
        "p1_element", "p1_element_3d", cell_coords3d.dtype, _P1_ARGTYPES
    )
    err = fn(
        cell_coords3d.data_ptr(), out.data_ptr(), T,
        torch.cuda.current_stream(cell_coords3d.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "p1_element_3d")
    cuda_build.launch_counts["p1_element_3d"] += 1
    return out


def coords_to_soa_3d(cell_coords3d: torch.Tensor) -> torch.Tensor:
    """(T, 3, 3) lifted cell coordinates -> padded (16, T_pad) SoA, the TPU
    kernel's input layout (padding cells: unit triangle in the xy plane).
    K1 needs no padding; this serves parity checks against the JAX
    package."""
    T = cell_coords3d.shape[0]
    t_pad = ((T + LANE_BLOCK - 1) // LANE_BLOCK) * LANE_BLOCK
    soa = cell_coords3d.new_zeros((IN_ROWS_3D, t_pad))
    soa[:9, :T] = cell_coords3d.reshape(T, 9).T
    if t_pad > T:
        soa[3, T:] = 1.0  # x1 = 1
        soa[7, T:] = 1.0  # y2 = 1
    return soa


def p1_local_stiffness_load_3d(cell_coords3d: torch.Tensor):
    """Intrinsic P1 local stiffness (T, 3, 3), f=1 load (T, 3), areas (T,)
    of embedded triangles from their (T, 3, 3) lifted vertex coordinates;
    2D meshes are padded with z = 0."""
    T = cell_coords3d.shape[0]
    if cell_coords3d.shape[-1] == 2:
        cell_coords3d = torch.cat(
            [cell_coords3d, torch.zeros_like(cell_coords3d[..., :1])], dim=-1
        )
    out = p1_element_3d(cell_coords3d.contiguous())
    return out[:9].T.reshape(T, 3, 3), out[9:12].T, out[12]


# -- 2D variant (K5) ----------------------------------------------------------


def _p1_plain(soa: torch.Tensor) -> torch.Tensor:
    """Plain version of K5 on SoA rows (x0 y0 x1 y1 x2 y2 scale ...).

    The elementwise formula of the Pallas ``_p1_kernel``; returns the
    (14, T) output rows.
    """
    x0, y0, x1, y1, x2, y2, scale = (soa[i] for i in range(7))
    ux1 = x1 - x0
    uy1 = y1 - y0
    ux2 = x2 - x0
    uy2 = y2 - y0

    det = ux1 * uy2 - ux2 * uy1
    inv_det = 1.0 / det
    area = 0.5 * det * scale

    g1x = (uy1 - uy2) * inv_det
    g1y = (ux2 - ux1) * inv_det
    g2x = uy2 * inv_det
    g2y = -ux2 * inv_det
    g3x = -uy1 * inv_det
    g3y = ux1 * inv_det

    s11 = area * (g1x * g1x + g1y * g1y)
    s12 = area * (g1x * g2x + g1y * g2y)
    s13 = area * (g1x * g3x + g1y * g3y)
    s22 = area * (g2x * g2x + g2y * g2y)
    s23 = area * (g2x * g3x + g2y * g3y)
    s33 = area * (g3x * g3x + g3y * g3y)
    load = area * (1.0 / 3.0)
    return torch.stack(
        [s11, s12, s13, s12, s22, s23, s13, s23, s33, load, load, load, area, det]
    )


def _soa_rows(cell_coords: torch.Tensor, scale: torch.Tensor | None = None):
    """(T, 3, 2) cells (+ optional (T,) scale) -> the (7, T) SoA rows
    x0 y0 x1 y1 x2 y2 scale that ``_p1_plain`` reads, unpadded."""
    T = cell_coords.shape[0]
    rows = cell_coords.new_ones((1, T)) if scale is None else scale.reshape(1, T)
    return torch.cat([cell_coords.reshape(T, 6).T, rows])


def p1_element_2d(cell_coords: torch.Tensor, scale: torch.Tensor | None = None):
    """(T, 3, 2) cell coordinates (+ optional (T,) scale) -> (14, T) K5
    output rows.

    CPU tensors take ``_p1_plain``; CUDA tensors launch K5 or raise.
    """
    T = cell_coords.shape[0]
    if cell_coords.device.type == "cpu":
        return _p1_plain(_soa_rows(cell_coords, scale))
    dtype = cell_coords.dtype
    cuda_build.check(cell_coords, "cell_coords", (T, 3, 2), dtype)
    if scale is not None:
        cuda_build.check(scale, "scale", (T,), dtype)
    out = torch.empty((P1_OUT_ROWS_2D, T), dtype=dtype, device=cell_coords.device)
    fn = cuda_build.function("p1_element", "p1_element_2d", dtype, _P1_2D_ARGTYPES)
    err = fn(
        cell_coords.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), T, torch.cuda.current_stream(cell_coords.device).cuda_stream,
    )
    cuda_build.raise_on_error(err, "p1_element_2d")
    cuda_build.launch_counts["p1_element_2d"] += 1
    return out


def coords_to_soa(cell_coords: torch.Tensor, scale: torch.Tensor | None = None):
    """(T, 3, 2) cell coordinates (+ optional (T,) scale) -> padded
    (8, T_pad) SoA, the TPU kernel's input layout (padding cells: the unit
    triangle with scale 0). K5 needs no padding; this serves parity checks
    against the JAX package."""
    T = cell_coords.shape[0]
    t_pad = ((T + LANE_BLOCK - 1) // LANE_BLOCK) * LANE_BLOCK
    soa = cell_coords.new_zeros((IN_ROWS, t_pad))
    soa[:6, :T] = cell_coords.reshape(T, 6).T
    soa[6, :T] = 1.0 if scale is None else scale.reshape(-1)
    if t_pad > T:
        soa[2, T:] = 1.0  # x1 = 1
        soa[5, T:] = 1.0  # y2 = 1
    return soa


def p1_local_stiffness_load(cell_coords: torch.Tensor, scale: torch.Tensor | None = None):
    """P1 local stiffness (T, 3, 3), load (T, 3) for f=1, and areas (T,)
    of planar cells from their (T, 3, 2) coordinates, each scaled by
    ``scale`` (T,) where given; through K5 on the card."""
    T = cell_coords.shape[0]
    if scale is not None:
        scale = scale.reshape(T).to(cell_coords).contiguous()
    out = p1_element_2d(cell_coords.contiguous(), scale)
    return out[:9].T.reshape(T, 3, 3), out[9:12].T, out[12]
