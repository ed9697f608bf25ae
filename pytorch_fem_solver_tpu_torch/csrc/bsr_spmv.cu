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
//
// bf16 values (the JAX package's values_dtype, and the bf16 inner copy of
// the multiplicative cycle): the value type is a template parameter apart
// from the x/y type. A 16-byte piece of bf16 is 8 values, one whole block
// row, so a lane owns a row, 8 lanes cover a block and 4 blocks go in one
// warp-wide load (a row's 8 tier-1 blocks are 2 such loads: kWaves is 2
// there, so the 8 x words a lane holds per wave stay within the register
// cap). The values' bytes halve against f32, the bound's other terms stay.
// Each x word is rounded to bf16 first (the JAX package's x.astype(bf16);
// a float64 x through float, as both frameworks round it), and each
// product of the two bf16 numbers is formed and summed in the dtype of x:
// exact products in f32, so the sums are what the plain version computes
// up to their order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kBlock = 8;
constexpr int kBlockWords = kBlock * kBlock;
constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 128;  // threads per thread block: 4 block-rows
constexpr int kMinBlocks = 8;  // resident blocks per SM to plan for: 64 registers

// What a lane loads and multiplies: one 16-byte piece V of values and the
// matching x words X (4 floats, 2 doubles; for bf16 values one block row
// of 8, against 8 words of x read as two float4 or four double2).
template <typename TV, typename TX>
struct Io;
template <>
struct Io<float, float> {
  using V = float4;
  using X = float4;
  static __device__ __forceinline__ X load_x(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float dot(const V& a, const X& b) {
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
  }
};
template <>
struct Io<double, double> {
  using V = double2;
  using X = double2;
  static __device__ __forceinline__ X load_x(const double* p) {
    return __ldg(reinterpret_cast<const double2*>(p));
  }
  static __device__ __forceinline__ double dot(const V& a, const X& b) {
    return a.x * b.x + a.y * b.y;
  }
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
__device__ __forceinline__ double bf16_round(double v) {
  // through float, as PyTorch and XLA round a double to bf16
  return static_cast<double>(bf16_round(static_cast<float>(v)));
}

template <typename TX>
struct Io<__nv_bfloat16, TX> {
  using V = uint4;  // 8 bf16: one row of a block
  static constexpr int kXPieces = 8 * sizeof(TX) / 16;
  using P = typename std::conditional<sizeof(TX) == 4, float4, double2>::type;
  struct X {
    TX w[8];
  };
  static __device__ __forceinline__ X load_x(const TX* p) {
    X out;
#pragma unroll
    for (int i = 0; i < kXPieces; ++i) {
      const P q = __ldg(reinterpret_cast<const P*>(p) + i);
      memcpy(out.w + i * (16 / sizeof(TX)), &q, 16);
    }
    return out;
  }
  static __device__ __forceinline__ TX dot(const V& a, const X& b) {
    __nv_bfloat162 h[4];
    memcpy(h, &a, 16);
    TX s = TX(0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      s += static_cast<TX>(f.x) * bf16_round(b.w[2 * i]);
      s += static_cast<TX>(f.y) * bf16_round(b.w[2 * i + 1]);
    }
    return s;
  }
};

template <typename TV, typename TX>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    bsr_spmv_rows(const int* __restrict__ bcols, const TV* __restrict__ v1,
                  const int* __restrict__ bcols2, const TV* __restrict__ v2,
                  const int* __restrict__ row_blocks,
                  const int* __restrict__ heavy_rank, const TX* __restrict__ x,
                  TX* __restrict__ y, int64_t nb, int64_t B, int64_t B2) {
  using V = typename Io<TV, TX>::V;
  using X = typename Io<TV, TX>::X;
  // warp-wide 16-byte loads of values in flight per lane
  constexpr int kWaves = sizeof(TV) == 2 ? 2 : 4;
  constexpr int kVec = 16 / sizeof(TV);             // values per piece
  constexpr int kLanesPerRow = kBlock / kVec;       // 2 (f32), 4 (f64), 1 (bf16)
  constexpr int kLanesPerBlock = kBlock * kLanesPerRow;  // 16, 32 or 8
  constexpr int kBlocksPerWave = kWarp / kLanesPerBlock;  // 2, 1 or 4

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

  TX acc = TX(0);
  for (int t0 = 0; t0 < count; t0 += kWaves * kBlocksPerWave) {
    const TV* vp[kWaves];
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
    V a[kWaves];
    X xv[kWaves];
#pragma unroll
    for (int w = 0; w < kWaves; ++w) {
      if (on[w]) {
        a[w] = __ldcs(reinterpret_cast<const V*>(vp[w]) + within);
        xv[w] = Io<TV, TX>::load_x(x + static_cast<int64_t>(col[w]) * kBlock + x_off);
      }
    }
#pragma unroll
    for (int w = 0; w < kWaves; ++w) {
      if (on[w]) acc += Io<TV, TX>::dot(a[w], xv[w]);
    }
  }
  // lanes of one output row: the kLanesPerRow neighbours, then the same
  // row of the wave's other blocks, kLanesPerBlock lanes apart
#pragma unroll
  for (int off = 1; off < kLanesPerRow; off <<= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
#pragma unroll
  for (int off = kLanesPerBlock; off < kWarp; off <<= 1) {
    acc += __shfl_xor_sync(kFull, acc, off);
  }
  if (lane < kLanesPerBlock && lane % kLanesPerRow == 0) {
    y[r * kBlock + lane / kLanesPerRow] = acc;
  }
}

template <typename TV, typename TX>
int launch(const int* bcols, const TV* v1, const int* bcols2, const TV* v2,
           const int* row_blocks, const int* heavy_rank, const TX* x, TX* y,
           int64_t nb, int64_t B, int64_t B2, cudaStream_t stream) {
  if (B < 1 || B2 < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb > 0) {
    constexpr int rows_per_block = kThreads / kWarp;
    const int64_t blocks = (nb + rows_per_block - 1) / rows_per_block;
    bsr_spmv_rows<TV, TX><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
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
  return launch<float, float>(bcols, v1, bcols2, v2, row_blocks, heavy_rank, x, y,
                              nb, B, B2, stream);
}

extern "C" int bsr_spmv_f64(const int* bcols, const double* v1, const int* bcols2,
                            const double* v2, const int* row_blocks,
                            const int* heavy_rank, const double* x, double* y,
                            int64_t nb, int64_t B, int64_t B2,
                            cudaStream_t stream) {
  return launch<double, double>(bcols, v1, bcols2, v2, row_blocks, heavy_rank, x,
                                y, nb, B, B2, stream);
}

extern "C" int bsr_spmv_bf16_f32(const int* bcols, const __nv_bfloat16* v1,
                                 const int* bcols2, const __nv_bfloat16* v2,
                                 const int* row_blocks, const int* heavy_rank,
                                 const float* x, float* y, int64_t nb, int64_t B,
                                 int64_t B2, cudaStream_t stream) {
  return launch<__nv_bfloat16, float>(bcols, v1, bcols2, v2, row_blocks,
                                       heavy_rank, x, y, nb, B, B2, stream);
}

extern "C" int bsr_spmv_bf16_f64(const int* bcols, const __nv_bfloat16* v1,
                                 const int* bcols2, const __nv_bfloat16* v2,
                                 const int* row_blocks, const int* heavy_rank,
                                 const double* x, double* y, int64_t nb,
                                 int64_t B, int64_t B2, cudaStream_t stream) {
  return launch<__nv_bfloat16, double>(bcols, v1, bcols2, v2, row_blocks,
                                       heavy_rank, x, y, nb, B, B2, stream);
}
