// K1: intrinsic P1 element kernel for embedded (DFN) triangles.
//
// Replaces: pytorch_fem_solver_tpu/ops/pallas_kernels.py:_p1_kernel_3d,
// launched by _p1_pallas_3d. Per triangle with lifted vertices p0, p1, p2:
// the edges e_i opposite vertex i, the area A = 1/2 |e2 x (p2 - p0)|, the
// stiffness S_ij = (e_i . e_j) / (4A), the f=1 load A/3 (x3) and the area.
//
// What bounds it on an H100: memory. Each cell reads 9 coordinates and
// writes 13 values (22 words, 88 bytes in f32) for about 60 floating-point
// operations, under one operation per byte, far below the card's ratio of
// peak f32 rate to bandwidth (about 20).
//
// Design: one thread per cell, no shared memory and no padding (the TPU
// kernel's 2048-lane blocks were a VMEM tiling choice). The input is the
// mesh's own (T, 3, 3) AoS layout, so no transpose pass runs before it: a
// warp's 32 cells are 1152 contiguous bytes and every fetched sector is
// used. The output is SoA (13, T), rows 0-8 the row-major 3x3 stiffness,
// 9-11 the load, 12 the area: each store instruction of a warp writes one
// contiguous segment, and the assembly reads the 6 canonical-pair rows and
// the 3 load rows as contiguous vectors.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__device__ __forceinline__ T dev_sqrt(T v);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double v) { return sqrt(v); }

template <typename T>
__global__ void p1_element_3d_kernel(const T* __restrict__ coords,
                                     T* __restrict__ out, int64_t n) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const T* p = coords + 9 * t;
  const T p0x = p[0], p0y = p[1], p0z = p[2];
  const T p1x = p[3], p1y = p[4], p1z = p[5];
  const T p2x = p[6], p2y = p[7], p2z = p[8];

  const T e0x = p2x - p1x, e0y = p2y - p1y, e0z = p2z - p1z;  // opposite 0
  const T e1x = p0x - p2x, e1y = p0y - p2y, e1z = p0z - p2z;  // opposite 1
  const T e2x = p1x - p0x, e2y = p1y - p0y, e2z = p1z - p0z;  // opposite 2

  // area from the cross product of two edges
  const T ux = p2x - p0x, uy = p2y - p0y, uz = p2z - p0z;
  const T cx = e2y * uz - e2z * uy;
  const T cy = e2z * ux - e2x * uz;
  const T cz = e2x * uy - e2y * ux;
  const T area = T(0.5) * dev_sqrt<T>(cx * cx + cy * cy + cz * cz);
  const T inv4a = T(0.25) / area;

  const T s00 = (e0x * e0x + e0y * e0y + e0z * e0z) * inv4a;
  const T s01 = (e0x * e1x + e0y * e1y + e0z * e1z) * inv4a;
  const T s02 = (e0x * e2x + e0y * e2y + e0z * e2z) * inv4a;
  const T s11 = (e1x * e1x + e1y * e1y + e1z * e1z) * inv4a;
  const T s12 = (e1x * e2x + e1y * e2y + e1z * e2z) * inv4a;
  const T s22 = (e2x * e2x + e2y * e2y + e2z * e2z) * inv4a;
  const T load = area * T(1.0 / 3.0);

  out[0 * n + t] = s00;
  out[1 * n + t] = s01;
  out[2 * n + t] = s02;
  out[3 * n + t] = s01;
  out[4 * n + t] = s11;
  out[5 * n + t] = s12;
  out[6 * n + t] = s02;
  out[7 * n + t] = s12;
  out[8 * n + t] = s22;
  out[9 * n + t] = load;
  out[10 * n + t] = load;
  out[11 * n + t] = load;
  out[12 * n + t] = area;
}

// K5: 2D P1 element kernel with a per-cell scale.
//
// Replaces: pytorch_fem_solver_tpu/ops/pallas_kernels.py:_p1_kernel, launched
// by _p1_pallas. Per cell with vertices p0, p1, p2 and scale s: the SIGNED
// det = (p1 - p0) x (p2 - p0) (no abs: a clockwise cell gives a negative
// area and stiffness, as on the TPU), area = 1/2 det s, the P1 gradients
// divided by det, S_ij = area (g_i . g_j), the f=1 load area/3 (x3), the
// area and det. The scale multiplies the stiffness as well as the load, so on
// a fracture chart this is the tangential stiffness only where the chart is
// an isometry (K1 is the kernel for general charts).
//
// What bounds it on an H100: memory, as K1. Each cell reads 6 coordinates
// and the scale and writes 14 values (21 words, 84 bytes in f32) for about
// 40 floating-point operations.
//
// Design: one thread per cell reading the mesh's (T, 3, 2) AoS coordinates
// as they are (a warp's 32 cells are 768 contiguous bytes) and writing SoA
// (14, T) rows: 0-8 the row-major stiffness, 9-11 the load, 12 the area,
// 13 det. This is the TPU kernel's output without its two zero rows and its
// 2048-lane padding. A null scale pointer means a scale of 1.
template <typename T>
__global__ void p1_element_2d_kernel(const T* __restrict__ coords,
                                     const T* __restrict__ scale,
                                     T* __restrict__ out, int64_t n) {
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n) return;
  const T* p = coords + 6 * t;
  const T x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3], x2 = p[4], y2 = p[5];
  const T s = scale ? scale[t] : T(1);

  const T ux1 = x1 - x0, uy1 = y1 - y0;
  const T ux2 = x2 - x0, uy2 = y2 - y0;
  const T det = ux1 * uy2 - ux2 * uy1;
  const T inv_det = T(1) / det;
  const T area = T(0.5) * det * s;

  const T g1x = (uy1 - uy2) * inv_det, g1y = (ux2 - ux1) * inv_det;
  const T g2x = uy2 * inv_det, g2y = -ux2 * inv_det;
  const T g3x = -uy1 * inv_det, g3y = ux1 * inv_det;

  const T s11 = area * (g1x * g1x + g1y * g1y);
  const T s12 = area * (g1x * g2x + g1y * g2y);
  const T s13 = area * (g1x * g3x + g1y * g3y);
  const T s22 = area * (g2x * g2x + g2y * g2y);
  const T s23 = area * (g2x * g3x + g2y * g3y);
  const T s33 = area * (g3x * g3x + g3y * g3y);
  const T load = area * T(1.0 / 3.0);

  out[0 * n + t] = s11;
  out[1 * n + t] = s12;
  out[2 * n + t] = s13;
  out[3 * n + t] = s12;
  out[4 * n + t] = s22;
  out[5 * n + t] = s23;
  out[6 * n + t] = s13;
  out[7 * n + t] = s23;
  out[8 * n + t] = s33;
  out[9 * n + t] = load;
  out[10 * n + t] = load;
  out[11 * n + t] = load;
  out[12 * n + t] = area;
  out[13 * n + t] = det;
}

constexpr int kThreads = 256;

template <typename T>
int launch(const T* coords, T* out, int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    p1_element_3d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        coords, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_2d(const T* coords, const T* scale, T* out, int64_t n,
              cudaStream_t stream) {
  if (n > 0) {
    const int64_t blocks = (n + kThreads - 1) / kThreads;
    p1_element_2d_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        coords, scale, out, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int p1_element_3d_f32(const float* coords, float* out, int64_t n,
                                 cudaStream_t stream) {
  return launch<float>(coords, out, n, stream);
}

extern "C" int p1_element_3d_f64(const double* coords, double* out, int64_t n,
                                 cudaStream_t stream) {
  return launch<double>(coords, out, n, stream);
}

extern "C" int p1_element_2d_f32(const float* coords, const float* scale,
                                 float* out, int64_t n, cudaStream_t stream) {
  return launch_2d<float>(coords, scale, out, n, stream);
}

extern "C" int p1_element_2d_f64(const double* coords, const double* scale,
                                 double* out, int64_t n, cudaStream_t stream) {
  return launch_2d<double>(coords, scale, out, n, stream);
}
