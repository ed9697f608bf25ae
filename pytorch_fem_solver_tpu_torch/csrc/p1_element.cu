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
// Design. The input is the mesh's own (T, 3, 3) AoS layout, so no transpose
// pass runs before it, and no padding (the TPU kernel's 2048-lane blocks were
// a VMEM tiling choice). The output is SoA (13, T), rows 0-8 the row-major
// 3x3 stiffness, 9-11 the load, 12 the area: the assembly reads the 6
// canonical-pair rows and the 3 load rows as contiguous vectors, and each
// of a warp's stores writes one full 128-byte line.
// - One thread per cell. A thread that reads its cell straight from global
//   memory asks, with each of its 9 loads, for a word 36 bytes from its
//   neighbour's: DRAM still delivers only sectors that are used, but L1
//   serves 9 lines of 128 bytes to each of a warp's 9 loads where 9 lines
//   hold all of the warp's data. So a thread block first copies its cells'
//   coordinates, which are contiguous, into shared memory with coalesced
//   16-byte streaming loads, all of a thread's loads in flight at once
//   (stage_cells, templated on the words per cell so that a kernel with
//   another cell size can take it); the last words of a block that do not
//   fill a piece come by one-word loads, so any T is taken.
// - After the barrier a thread reads its 9 words back at a stride of 9
//   words, which is odd, so a warp's 32 reads hit 32 different banks: no
//   conflict and no padding (staged_word_offsets in ops/kernels.py is the
//   same map, held by a CPU test).
// - A misaligned `coords` takes the same kernel with one-word loads.
// - One cell per thread and one-word stores: 2 or 4 cells per thread with
//   8- or 16-byte stores measure slower, the kernel wants many warps more
//   than wide stores.
// - The arithmetic of a cell (p1_cell_3d) is one sequence of operations, so
//   the values do not depend on the path taken.

#include <cuda_runtime.h>

#include <cstdint>

#include "pieces.cuh"

namespace {

constexpr int kK1Threads = 128;  // K1: threads (cells) per block
constexpr int kK5Threads = 128;  // K5: threads (cells) per block

template <typename T>
__device__ __forceinline__ T dev_sqrt(T v);
template <>
__device__ __forceinline__ float dev_sqrt<float>(float v) { return sqrtf(v); }
template <>
__device__ __forceinline__ double dev_sqrt<double>(double v) { return sqrt(v); }

// The calling block's cells, W words each and contiguous from src, through
// shared memory into registers. `words` words are copied into tile: whole
// pieces of L words with coalesced loads (thread t takes pieces t,
// t + Threads, ...; all its loads are started before the first is stored;
// L > 1 needs src on a 16-byte boundary), the words left over one by one.
// After the barrier thread t takes the W words of its cell into mine, R
// words at a time, at a stride of W words from its neighbour's. A warp's
// reads are free of bank conflicts when W is odd and R = 1 (K1), and for
// W = 6 with R = 2: 8-byte reads in f32 and 16-byte reads in f64, where each
// phase of 16 or 8 threads covers the 32 banks once (K5). tile holds
// Threads W words on a 16-byte boundary; every thread of the block must call.
template <typename T, int L, int W, int Threads, int R = 1>
__device__ __forceinline__ void stage_cells(const T* __restrict__ src, int words, T* tile,
                                            T (&mine)[W]) {
  static_assert(W % R == 0, "a cell is a whole number of read-back pieces");
  constexpr int kLoads = (W + L - 1) / L;  // per thread
  const int tid = static_cast<int>(threadIdx.x);
  const int pieces = words / L;
  Piece<T, L> hold[kLoads];
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int q = tid + m * Threads;
    if (q < pieces) hold[m] = load_streaming<T, L>(src + static_cast<int64_t>(q) * L);
  }
  const int rest = pieces * L + tid;
  if (rest < words) tile[rest] = __ldcs(src + rest);
#pragma unroll
  for (int m = 0; m < kLoads; ++m) {
    const int q = tid + m * Threads;
    if (q < pieces) *reinterpret_cast<Piece<T, L>*>(tile + q * L) = hold[m];
  }
  __syncthreads();
  if (tid * W >= words) return;
#pragma unroll
  for (int m = 0; m < W; m += R) {
    const Piece<T, R> v = *reinterpret_cast<const Piece<T, R>*>(tile + tid * W + m);
#pragma unroll
    for (int r = 0; r < R; ++r) mine[m + r] = v.v[r];
  }
}

// One cell: p its 9 coordinates; o = s00 s01 s02 s11 s12 s22 load area.
template <typename T>
__device__ __forceinline__ void p1_cell_3d(const T* p, T* o) {
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

  o[0] = (e0x * e0x + e0y * e0y + e0z * e0z) * inv4a;
  o[1] = (e0x * e1x + e0y * e1y + e0z * e1z) * inv4a;
  o[2] = (e0x * e2x + e0y * e2y + e0z * e2z) * inv4a;
  o[3] = (e1x * e1x + e1y * e1y + e1z * e1z) * inv4a;
  o[4] = (e1x * e2x + e1y * e2y + e1z * e2z) * inv4a;
  o[5] = (e2x * e2x + e2y * e2y + e2z * e2z) * inv4a;
  o[6] = area * T(1.0 / 3.0);
  o[7] = area;
}

// L words per load into shared memory: 16 / sizeof(T) for an aligned
// `coords`, 1 otherwise.
template <typename T, int L>
__global__ void __launch_bounds__(kK1Threads)
    p1_element_3d_kernel(const T* __restrict__ coords, T* __restrict__ out, int64_t n) {
  constexpr int W = 9;  // words per cell
  __shared__ __align__(16) T tile[kK1Threads * W];
  const int64_t block_first = blockIdx.x * static_cast<int64_t>(kK1Threads);
  const int64_t left = n - block_first;
  const int cells = left < kK1Threads ? static_cast<int>(left) : kK1Threads;
  T p[W];
  // kK1Threads W words are a whole number of 16-byte pieces, so every block
  // starts on a 16-byte boundary if coords does
  stage_cells<T, L, W, kK1Threads>(coords + block_first * W, cells * W, tile, p);
  if (static_cast<int>(threadIdx.x) >= cells) return;

  T o[8];
  p1_cell_3d<T>(p, o);
  T* dst = out + block_first + threadIdx.x;
  dst[0 * n] = o[0], dst[1 * n] = o[1], dst[2 * n] = o[2];
  dst[3 * n] = o[1], dst[4 * n] = o[3], dst[5 * n] = o[4];
  dst[6 * n] = o[2], dst[7 * n] = o[4], dst[8 * n] = o[5];
  dst[9 * n] = o[6], dst[10 * n] = o[6], dst[11 * n] = o[6];
  dst[12 * n] = o[7];
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
// Design: K1's. The input is the mesh's (T, 3, 2) AoS coordinates as they
// are, the output SoA (14, T) rows: 0-8 the row-major stiffness, 9-11 the
// load, 12 the area, 13 det (the TPU kernel's output without its two zero
// rows and its 2048-lane padding). A null scale pointer means a scale of 1.
// - One thread per cell. A block stages its cells' coordinates through
//   shared memory with coalesced 16-byte streaming loads (stage_cells), so a
//   warp's loads ask for the 768 bytes of its 32 cells once, where 6 loads
//   of one word each at a stride of 24 bytes asked L1 for them six times.
// - A cell is 6 words, an even stride, so one-word reads would meet two to
//   a bank; each thread reads its cell back as 3 pieces of 2 words (8 bytes
//   in f32, 16 in f64), which no two threads of a phase share a bank with
//   (staged_word_offsets in ops/kernels.py is the same map, held by a CPU
//   test for both types). No padding.
// - The scale is one coalesced word per thread, asked for before the
//   staging so its trip to memory overlaps it.
// - A misaligned `coords` takes the same kernel with one-word loads.
// - One-word stores: each of a warp's 14 stores writes one whole line.
// - The arithmetic of a cell (p1_cell_2d) is the expression of the first
//   version of this kernel, in the same order, so its float32 output is
//   bitwise the same.
template <typename T>
__device__ __forceinline__ void p1_cell_2d(const T* p, T s, T* o) {
  const T x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3], x2 = p[4], y2 = p[5];

  const T ux1 = x1 - x0, uy1 = y1 - y0;
  const T ux2 = x2 - x0, uy2 = y2 - y0;
  const T det = ux1 * uy2 - ux2 * uy1;
  const T inv_det = T(1) / det;
  const T area = T(0.5) * det * s;

  const T g1x = (uy1 - uy2) * inv_det, g1y = (ux2 - ux1) * inv_det;
  const T g2x = uy2 * inv_det, g2y = -ux2 * inv_det;
  const T g3x = -uy1 * inv_det, g3y = ux1 * inv_det;

  o[0] = area * (g1x * g1x + g1y * g1y);  // s11
  o[1] = area * (g1x * g2x + g1y * g2y);  // s12
  o[2] = area * (g1x * g3x + g1y * g3y);  // s13
  o[3] = area * (g2x * g2x + g2y * g2y);  // s22
  o[4] = area * (g2x * g3x + g2y * g3y);  // s23
  o[5] = area * (g3x * g3x + g3y * g3y);  // s33
  o[6] = area * T(1.0 / 3.0);             // load
  o[7] = area;
  o[8] = det;
}

template <typename T, int L>
__global__ void __launch_bounds__(kK5Threads)
    p1_element_2d_kernel(const T* __restrict__ coords, const T* __restrict__ scale,
                         T* __restrict__ out, int64_t n) {
  constexpr int W = 6;  // words per cell
  __shared__ __align__(16) T tile[kK5Threads * W];
  const int64_t block_first = blockIdx.x * static_cast<int64_t>(kK5Threads);
  const int64_t left = n - block_first;
  const int cells = left < kK5Threads ? static_cast<int>(left) : kK5Threads;
  const int tid = static_cast<int>(threadIdx.x);
  const T s = (scale && tid < cells) ? __ldcs(scale + block_first + tid) : T(1);
  T p[W];
  // kK5Threads W words are a whole number of 16-byte pieces, so every block
  // starts on a 16-byte boundary if coords does
  stage_cells<T, L, W, kK5Threads, 2>(coords + block_first * W, cells * W, tile, p);
  if (tid >= cells) return;

  T o[9];
  p1_cell_2d<T>(p, s, o);
  T* dst = out + block_first + tid;
  dst[0 * n] = o[0], dst[1 * n] = o[1], dst[2 * n] = o[2];
  dst[3 * n] = o[1], dst[4 * n] = o[3], dst[5 * n] = o[4];
  dst[6 * n] = o[2], dst[7 * n] = o[4], dst[8 * n] = o[5];
  dst[9 * n] = o[6], dst[10 * n] = o[6], dst[11 * n] = o[6];
  dst[12 * n] = o[7], dst[13 * n] = o[8];
}

template <typename T>
int launch(const T* coords, T* out, int64_t n, cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kK1Threads - 1) / kK1Threads);
    if (reinterpret_cast<uintptr_t>(coords) % 16 == 0) {
      p1_element_3d_kernel<T, 16 / sizeof(T)><<<blocks, kK1Threads, 0, stream>>>(coords, out, n);
    } else {
      p1_element_3d_kernel<T, 1><<<blocks, kK1Threads, 0, stream>>>(coords, out, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_2d(const T* coords, const T* scale, T* out, int64_t n,
              cudaStream_t stream) {
  if (n > 0) {
    const unsigned blocks = static_cast<unsigned>((n + kK5Threads - 1) / kK5Threads);
    if (reinterpret_cast<uintptr_t>(coords) % 16 == 0) {
      p1_element_2d_kernel<T, 16 / sizeof(T)><<<blocks, kK5Threads, 0, stream>>>(
          coords, scale, out, n);
    } else {
      p1_element_2d_kernel<T, 1><<<blocks, kK5Threads, 0, stream>>>(coords, scale, out, n);
    }
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
