// K2: hybrid 8x8 block-sparse matrix-vector product, y = A x.
//
// Replaces: tools/exp_pallas_spmv.py:kernel (launched by pallas_spmv), the
// TPU sketch of the tier-1 product with x resident on chip, and the XLA
// composition of pytorch_fem_solver_tpu/ops/bsr.py:bsr_matvec that the JAX
// main path runs once per PCG iteration: tier 1 over (nb, B) blocks whose
// slot b=0 is the own block, then the spilled tier-2 blocks (nh, B2) of the
// heavy rows added back.
//
// What bounds it on an H100: memory. A product needs every stored block
// once (256 B in f32, 512 B in f64) plus its block column, the two vectors
// and two small per-row tables, for 2 flops per value word: 0.5 flop/byte
// in f32. Both value arrays are padded to their widths B and B2 (at the
// 107k-DOF benchmark 159,744 slots hold 98,372 stored blocks; tier 2 is
// (3,488, 16) for 11,509 blocks, its width set by one row), so the padding,
// not the matrix, is what a slot-by-slot walk mostly streams there.
//
// Design.
// - No padding is read. The slots of a block-row are filled from the front,
//   so the per-row count of stored blocks (row_blocks) says where the row
//   ends: its first min(count, B) blocks sit in tier 1, the rest in row
//   heavy_rank[r] of tier 2. Empty block-rows write y = 0.
// - One launch, one warp per block-row. The warp walks the row's tier-1 and
//   tier-2 blocks as one list, so tier 2 costs no second kernel, no
//   read-modify-write of y and no atomics.
// - 16-byte loads, all of a chunk issued before the first sum. A lane owns
//   one 16-byte piece of a block: in f32 (row i, half h) with 16 lanes per
//   block and two blocks per warp-wide load, in f64 (row i, quarter q) with
//   32 lanes per block. A row's tier-1 values are one contiguous run, so
//   the warp reads whole 512-byte lines. Up to kWaves loads of values, and
//   the matching 16-byte pieces of x, are in flight per lane before any
//   multiply; the common row (8 blocks in f32) is one such chunk. The
//   chunk's block columns are asked for together with the row's count, so a
//   warp's chain is two loads deep (count and columns, then values and x).
// - Registers are capped at 64 a thread (eight 128-thread blocks per SM):
//   short-lived warps hide each other's chains, and on the card this
//   occupancy beat both more registers and fewer.
// - x (416 KB in f32 at the benchmark) stays in the 50 MB L2, which plays
//   the part VMEM plays in the TPU sketch: values are loaded with the
//   streaming hint so they do not evict it, x through the read-only path.
// - The 8 row sums are finished by a fixed sequence of xor shuffles, so y
//   is bitwise the same on every run. Sums run in the dtype of x.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 8;
constexpr int kBlockWords = kBlock * kBlock;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // threads per thread block: 4 block-rows
constexpr int kWaves = 4;  // warp-wide 16-byte loads of values in flight per lane
constexpr int kMinBlocks = 8;  // resident blocks per SM to plan for: 64 registers

// One 16-byte piece: 4 floats or 2 doubles.
template <typename T>
struct Piece;
template <>
struct Piece<float> {
  using type = float4;
};
template <>
struct Piece<double> {
  using type = double2;
};

__device__ __forceinline__ float dot(const float4& a, const float4& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}
__device__ __forceinline__ double dot(const double2& a, const double2& b) {
  return a.x * b.x + a.y * b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bsr_spmv_rows(const int* __restrict__ bcols, const T* __restrict__ v1,
                  const int* __restrict__ bcols2, const T* __restrict__ v2,
                  const int* __restrict__ row_blocks,
                  const int* __restrict__ heavy_rank, const T* __restrict__ x,
                  T* __restrict__ y, int64_t nb, int64_t B, int64_t B2) {
  using V = typename Piece<T>::type;
  constexpr int kVec = 16 / sizeof(T);              // words per piece
  constexpr int kLanesPerRow = kBlock / kVec;       // 2 (f32) or 4 (f64)
  constexpr int kLanesPerBlock = kBlock * kLanesPerRow;  // 16 or 32
  constexpr int kBlocksPerWave = kWarp / kLanesPerBlock;  // 2 or 1

  const int lane = threadIdx.x % kWarp;
  const int64_t r =
      blockIdx.x * static_cast<int64_t>(kThreads / kWarp) + threadIdx.x / kWarp;
  if (r >= nb) return;  // whole warps leave

  const int sub = lane / kLanesPerBlock;      // which block of a wave
  const int within = lane % kLanesPerBlock;   // which piece of the block
  const int x_off = (within % kLanesPerRow) * kVec;

  // the tier-1 columns of the first chunk, asked for beside the row's
  // counts and not after them (padded column slots are valid memory)
  int first_col[kWaves];
#pragma unroll
  for (int w = 0; w < kWaves; ++w) {
    const int t = w * kBlocksPerWave + sub;
    first_col[w] = t < B ? __ldg(bcols + r * B + t) : 0;
  }
  const int count = __ldg(row_blocks + r);
  const int64_t spill = __ldg(heavy_rank + r);
  const int in_tier1 = count < B ? count : static_cast<int>(B);

  T acc = T(0);
  for (int t0 = 0; t0 < count; t0 += kWaves * kBlocksPerWave) {
    const T* vp[kWaves];
    int col[kWaves];
    bool on[kWaves];
#pragma unroll
    for (int w = 0; w < kWaves; ++w) {
      const int t = t0 + w * kBlocksPerWave + sub;
      on[w] = t < count;
      col[w] = 0;
      vp[w] = v1;
      if (on[w]) {
        if (t < in_tier1) {
          const int64_t slot = r * B + t;
          col[w] = t0 == 0 ? first_col[w] : __ldg(bcols + slot);
          vp[w] = v1 + slot * kBlockWords;
        } else {
          const int64_t slot = spill * B2 + (t - in_tier1);
          col[w] = __ldg(bcols2 + slot);
          vp[w] = v2 + slot * kBlockWords;
        }
      }
    }
    V a[kWaves], xv[kWaves];
#pragma unroll
    for (int w = 0; w < kWaves; ++w) {
      if (on[w]) {
        a[w] = __ldcs(reinterpret_cast<const V*>(vp[w]) + within);
        xv[w] = __ldg(reinterpret_cast<const V*>(
            x + static_cast<int64_t>(col[w]) * kBlock + x_off));
      }
    }
#pragma unroll
    for (int w = 0; w < kWaves; ++w) {
      if (on[w]) acc += dot(a[w], xv[w]);
    }
  }
  // lanes of one output row: the kLanesPerRow neighbours, in f32 also the
  // other block of the wave 16 lanes away
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (kBlocksPerWave == 2) acc += __shfl_xor_sync(kFull, acc, kLanesPerBlock);
  if (lane < kLanesPerBlock && lane % kLanesPerRow == 0) {
    y[r * kBlock + lane / kLanesPerRow] = acc;
  }
}

template <typename T>
int launch(const int* bcols, const T* v1, const int* bcols2, const T* v2,
           const int* row_blocks, const int* heavy_rank, const T* x, T* y,
           int64_t nb, int64_t B, int64_t B2, cudaStream_t stream) {
  if (B < 1 || B2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    constexpr int rows_per_block = kThreads / kWarp;
    const int64_t blocks = (nb + rows_per_block - 1) / rows_per_block;
    bsr_spmv_rows<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        bcols, v1, bcols2, v2, row_blocks, heavy_rank, x, y, nb, B, B2);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int bsr_spmv_f32(const int* bcols, const float* v1, const int* bcols2,
                            const float* v2, const int* row_blocks,
                            const int* heavy_rank, const float* x, float* y,
                            int64_t nb, int64_t B, int64_t B2,
                            cudaStream_t stream) {
  return launch<float>(bcols, v1, bcols2, v2, row_blocks, heavy_rank, x, y, nb, B,
                       B2, stream);
}

extern "C" int bsr_spmv_f64(const int* bcols, const double* v1, const int* bcols2,
                            const double* v2, const int* row_blocks,
                            const int* heavy_rank, const double* x, double* y,
                            int64_t nb, int64_t B, int64_t B2,
                            cudaStream_t stream) {
  return launch<double>(bcols, v1, bcols2, v2, row_blocks, heavy_rank, x, y, nb, B,
                        B2, stream);
}
