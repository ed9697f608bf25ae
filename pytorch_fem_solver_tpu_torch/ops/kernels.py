"""P1 element kernel for embedded triangles (counterpart of
``pytorch_fem_solver_tpu/ops/pallas_kernels.py``, 3D variant).

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
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build

#: output rows of K1: 9 stiffness, 3 load, area
P1_OUT_ROWS = 13
#: 3D SoA input rows of the TPU layout: x0 y0 z0 x1 y1 z1 x2 y2 z2 + 7 pad
IN_ROWS_3D = 16
#: the TPU kernel's lane block (the SoA padding unit of ``coords_to_soa_3d``)
LANE_BLOCK = 2048

_P1_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]


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
