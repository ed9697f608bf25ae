// K2: hybrid 8x8 block-sparse matrix-vector product, y = A x.
//
// Replaces: tools/exp_pallas_spmv.py:kernel (launched by pallas_spmv), the
// TPU sketch of the tier-1 product with x resident on chip, and the XLA
// composition of pytorch_fem_solver_tpu/ops/bsr.py:bsr_matvec that the JAX
// main path runs once per PCG iteration: tier 1 over (nb, B) blocks whose
// slot b=0 is the own block and whose padding blocks point at block 0 with
// zero values, then the spilled tier-2 blocks of the heavy rows added back.
//
// What bounds it on an H100: memory. Every iteration streams the block
// values once (nb*B*64 words, 26.6 MB in f32 for the 107k-DOF benchmark)
// plus the block-column tables and the two vectors, for 2 flops per value
// word: 0.5 flop/byte in f32.
//
// Design: 8 threads per block-row, one per output row i. For each of the
// B blocks a thread reads its own 32-byte row of the 8x8 block with
// 16-byte vector loads (the 8 threads of a block-row read 256 contiguous
// bytes) and the 8-vector x[bcols[r, b]]. The whole x (about 416 KB in f32)
// stays in the 50 MB L2, so the gathers cost L2, not HBM, traffic. Sums
// run in the dtype of x and values. The tier-2 rows are sorted and unique,
// so a second small kernel adds them into y on the same stream with no
// atomics.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 8;
constexpr int kThreads = 256;  // 32 block-rows per thread block

// Load the 8 consecutive values at p (32-byte aligned) with 16-byte loads.
__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const double* __restrict__ p, double v[8]) {
  const double2* q = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const double2 a = __ldg(q + k);
    v[2 * k] = a.x;
    v[2 * k + 1] = a.y;
  }
}

// acc + sum_j vals[row, b, i, j] * x[cols[b] * 8 + j] over the nblk blocks.
template <typename T>
__device__ __forceinline__ T block_row_dot(const int* __restrict__ cols,
                                           const T* __restrict__ vals,
                                           const T* __restrict__ x, int64_t nblk,
                                           int i, T acc) {
  for (int64_t b = 0; b < nblk; ++b) {
    const int64_t c = __ldg(cols + b);
    T v[8], xv[8];
    load8(vals + (b * kBlock + i) * kBlock, v);
    load8(x + c * kBlock, xv);
#pragma unroll
    for (int j = 0; j < kBlock; ++j) acc += v[j] * xv[j];
  }
  return acc;
}

template <typename T>
__global__ void bsr_spmv_tier1(const int* __restrict__ bcols,
                               const T* __restrict__ v1, const T* __restrict__ x,
                               T* __restrict__ y, int64_t nb, int64_t B) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t r = tid / kBlock;
  const int i = static_cast<int>(tid % kBlock);
  if (r >= nb) return;
  y[r * kBlock + i] = block_row_dot<T>(bcols + r * B, v1 + r * B * kBlock * kBlock,
                                       x, B, i, T(0));
}

template <typename T>
__global__ void bsr_spmv_tier2(const int* __restrict__ bcols2,
                               const T* __restrict__ v2, const T* __restrict__ x,
                               const int* __restrict__ heavy_rows,
                               T* __restrict__ y, int64_t nh, int64_t B2) {
  const int64_t tid = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t h = tid / kBlock;
  const int i = static_cast<int>(tid % kBlock);
  if (h >= nh) return;
  const T add = block_row_dot<T>(bcols2 + h * B2, v2 + h * B2 * kBlock * kBlock,
                                 x, B2, i, T(0));
  const int64_t row = static_cast<int64_t>(heavy_rows[h]) * kBlock + i;
  y[row] += add;
}

template <typename T>
int launch(const int* bcols, const T* v1, const T* x, T* y, int64_t nb, int64_t B,
           const int* bcols2, const T* v2, const int* heavy_rows, int64_t nh,
           int64_t B2, cudaStream_t stream) {
  if (nb > 0) {
    const int64_t blocks = (nb * kBlock + kThreads - 1) / kThreads;
    bsr_spmv_tier1<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        bcols, v1, x, y, nb, B);
  }
  if (nh > 0 && B2 > 0) {
    const int64_t blocks = (nh * kBlock + kThreads - 1) / kThreads;
    bsr_spmv_tier2<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        bcols2, v2, x, heavy_rows, y, nh, B2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_spmv_f32(const int* bcols, const float* v1, const float* x,
                            float* y, int64_t nb, int64_t B, const int* bcols2,
                            const float* v2, const int* heavy_rows, int64_t nh,
                            int64_t B2, cudaStream_t stream) {
  return launch<float>(bcols, v1, x, y, nb, B, bcols2, v2, heavy_rows, nh, B2,
                       stream);
}

extern "C" int bsr_spmv_f64(const int* bcols, const double* v1, const double* x,
                            double* y, int64_t nb, int64_t B, const int* bcols2,
                            const double* v2, const int* heavy_rows, int64_t nh,
                            int64_t B2, cudaStream_t stream) {
  return launch<double>(bcols, v1, x, y, nb, B, bcols2, v2, heavy_rows, nh, B2,
                        stream);
}
