// K3 and K4: the fused tail of one aggregate-block two-level PCG iteration.
//
// Replaces: tools/exp_pallas_fused_pcg.py:k1_kernel (K3, launched by k1) and
// tools/exp_pallas_fused_pcg.py:k2_kernel (K4, launched by k2). Around them
// the iteration keeps the SpMV (K2), alpha = rz / dot(p, ap) before K3 and
// p = z + beta p after K4. On the (ns, gs) views of the padded vectors:
//
//   K3 agg_smooth_restrict:  xn = x + alpha p;  rn = r - alpha ap;
//                            s[i] = inv_agg[i] @ rn[i]  (gs x gs per row i);
//                            rc[i] = sum_j rn[i, j]
//   K4 coarse_prolong_dot:   zc = coarse_inv @ rc;  z[i, :] = s[i, :] + zc[i];
//                            rz = sum rn * z
//
// K4's prolongation is the fused algebra's precondition g == gs and
// nc == ns: coarse unknown i is the sum over smoother row i. alpha is a
// device scalar read through a pointer, so the loop never reads the device
// from the host.
//
// What bounds them on an H100: memory. K3 reads the (ns, gs, gs) smoother
// inverses once (13.3 MB in f32 at the 107k-DOF benchmark: ns = 3,248,
// gs = 32) plus 7 vectors of n_pad words, about 16.2 MB, for 2 flops per
// inverse word: 4.8 us at 3.35 TB/s. K4 reads the dense (nc, nc) coarse
// inverse once (42.2 MB in f32 at nc = 3,248) plus 3 vectors: 13.0 us.
//
// Design. The TPU kernels' padding of rows to 128-row tiles and of the
// coarse dimension to 128 lanes is a TPU layout and is dropped: both kernels
// read the unpadded tables as they are.
// - K3, gs == 32: one warp per aggregate row, lane j owning rn[i, j]; four
//   rows per thread block. The warp stages the 4 KB block inv_agg[i]
//   through shared memory with coalesced row loads, at a row stride of 33
//   words so that lane j reading row j of the block hits 32 different
//   banks. rn[i, k] reaches lane j by a shuffle. The block is not assumed
//   symmetric (the unpivoted Gauss-Jordan inverse is symmetric only to
//   roundoff). rc[i] is a butterfly shuffle sum, bitwise the same on every
//   lane and every run.
// - K3, other gs (<= 1024): one thread block of gs threads per row; rn[i]
//   is staged in shared memory, thread j reads row j of inv_agg[i] from
//   global memory, and thread 0 sums rc[i] in index order.
// - K4 is a dense matrix-vector product whose matrix is read once: no
//   tensor core helps (0.5 flop per byte), the card's means are wide loads
//   and enough of them in flight.
//   * A persistent grid of kK4BlocksPerSM (2) thread blocks per SM, each
//     of ceil(nc / blocks) warps (at most 32); warp w of block b owns rows
//     b + w * blocks, then every (warps * blocks)-th after it, so at the
//     benchmark (3,248 rows, 264 blocks of 13 warps) every SM holds 24 to
//     26 rows, each warp at most one, and no SM is left with a longer tail.
//   * rc is staged in shared memory once per thread block with 16-byte
//     loads (dynamic shared memory, 13 KB in f32 and 26 KB in f64 at
//     nc = 3,248; above 48 KB the launcher raises the kernel's limit
//     first), so it is read from L2 once per block and not once per row.
//   * A lane reads its row of coarse_inv 16 bytes at a time (float4 /
//     double2, streaming hint), kK4Unroll independent loads in flight, the
//     first batch issued before rc is staged. Rows are 16-byte aligned only
//     when nc * sizeof(T) is a multiple of 16 (3,248 * 4 is); for any other
//     nc, or a misaligned base, the launcher takes the same kernel with
//     one-word loads.
//   * zc[i] is a butterfly shuffle sum; the warp then writes z[i, :] and
//     its share of rn . z (s and rn of the row are fetched before the
//     matrix row, so their latency hides behind it). A block adds its
//     warps' shares in warp order into one partial.
//   * rz is the sum of the blocks' partials in a fixed order with no float
//     atomics, so repeated solves take the same iteration count. It is
//     folded into the same launch: a block adds one to an integer counter
//     when its partial is written, and the block that finds it was the
//     last sums them (a tree of a fixed shape) and resets the counter, so
//     graph replays work. A second one-block launch for the sum was
//     slower on the card by about its launch gap, and was dropped.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // K3: warps (rows) per thread block
constexpr int kK4BlocksPerSM = 2;  // K4's persistent grid: thread blocks per SM
constexpr int kK4Unroll = 4;  // K4: 16-byte loads of coarse_inv in flight per lane
constexpr int kK4MaxThreads = 1024;
// dynamic shared memory a K4 block may take for rc: the card's 227 KB less
// the kernel's static words
constexpr size_t kK4MaxShared = 226 * 1024;

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    agg_smooth_restrict_32(const T* __restrict__ alpha_p, const T* __restrict__ x,
                           const T* __restrict__ r, const T* __restrict__ p,
                           const T* __restrict__ ap, const T* __restrict__ inv,
                           T* __restrict__ xn, T* __restrict__ rn_out,
                           T* __restrict__ s, T* __restrict__ rc, int64_t ns) {
  __shared__ T tile[kRowsPerBlock][kWarp * (kWarp + 1)];
  const int lane = threadIdx.x % kWarp;
  const int w = threadIdx.x / kWarp;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kRowsPerBlock) + w;
  if (i >= ns) return;  // whole warps leave; only __syncwarp below

  const T alpha = __ldg(alpha_p);
  const int64_t e = i * kWarp + lane;
  const T rn = __ldg(r + e) - alpha * __ldg(ap + e);
  xn[e] = __ldg(x + e) + alpha * __ldg(p + e);
  rn_out[e] = rn;

  const T* blk = inv + i * kWarp * kWarp;
  T* t = tile[w];
#pragma unroll 8
  for (int row = 0; row < kWarp; ++row) {
    t[row * (kWarp + 1) + lane] = __ldg(blk + row * kWarp + lane);
  }
  __syncwarp();
  T acc = T(0);
#pragma unroll
  for (int k = 0; k < kWarp; ++k) {
    acc += t[lane * (kWarp + 1) + k] * __shfl_sync(kFull, rn, k);
  }
  s[e] = acc;
  const T sum = warp_sum(rn);
  if (lane == 0) rc[i] = sum;
}

template <typename T>
__global__ void agg_smooth_restrict_any(const T* __restrict__ alpha_p,
                                        const T* __restrict__ x,
                                        const T* __restrict__ r,
                                        const T* __restrict__ p,
                                        const T* __restrict__ ap,
                                        const T* __restrict__ inv,
                                        T* __restrict__ xn, T* __restrict__ rn_out,
                                        T* __restrict__ s, T* __restrict__ rc,
                                        int gs) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rn_s = reinterpret_cast<T*>(smem);
  const int64_t i = blockIdx.x;
  const int j = threadIdx.x;
  const T alpha = __ldg(alpha_p);
  const int64_t e = i * gs + j;
  const T rn = __ldg(r + e) - alpha * __ldg(ap + e);
  xn[e] = __ldg(x + e) + alpha * __ldg(p + e);
  rn_out[e] = rn;
  rn_s[j] = rn;
  __syncthreads();
  const T* row = inv + e * gs;
  T acc = T(0);
  for (int k = 0; k < gs; ++k) acc += __ldg(row + k) * rn_s[k];
  s[e] = acc;
  if (j == 0) {
    T sum = T(0);
    for (int k = 0; k < gs; ++k) sum += rn_s[k];
    rc[i] = sum;
  }
}

// One aligned piece of N words: 16 bytes for (float, 4) and (double, 2).
template <typename T, int N>
struct alignas(N * sizeof(T)) Piece {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Piece<T, N> load_streaming(const T* p);
template <>
__device__ __forceinline__ Piece<float, 4> load_streaming<float, 4>(const float* p) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  return {{a.x, a.y, a.z, a.w}};
}
template <>
__device__ __forceinline__ Piece<double, 2> load_streaming<double, 2>(const double* p) {
  const double2 a = __ldcs(reinterpret_cast<const double2*>(p));
  return {{a.x, a.y}};
}
template <>
__device__ __forceinline__ Piece<float, 1> load_streaming<float, 1>(const float* p) {
  return {{__ldcs(p)}};
}
template <>
__device__ __forceinline__ Piece<double, 1> load_streaming<double, 1>(const double* p) {
  return {{__ldcs(p)}};
}

// Sum of the n values at buf over the calling thread block, in an order
// fixed by n and blockDim alone; the result is valid in thread 0. scratch
// holds blockDim / 32 words of shared memory.
template <typename T>
__device__ __forceinline__ T block_sum_fixed(const T* buf, int64_t n, T* scratch) {
  T acc = T(0);
  for (int64_t k = threadIdx.x; k < n; k += blockDim.x) acc += __ldcg(buf + k);
  acc = warp_sum(acc);
  if (threadIdx.x % kWarp == 0) scratch[threadIdx.x / kWarp] = acc;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0) {
    for (int w = 0; w < static_cast<int>(blockDim.x) / kWarp; ++w) total += scratch[w];
  }
  return total;
}

// N words per load: 16 / sizeof(T) on the aligned path, 1 otherwise.
template <typename T, int N>
__global__ void __launch_bounds__(kK4MaxThreads)
    coarse_prolong_rows(const T* __restrict__ cinv, const T* __restrict__ rc,
                        const T* __restrict__ s, const T* __restrict__ rn,
                        T* __restrict__ z, T* partial, unsigned* counter,
                        T* __restrict__ rz, int64_t nc, int gs, bool rc_wide) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* rc_s = reinterpret_cast<T*>(smem);
  __shared__ T scratch[kK4MaxThreads / kWarp];
  __shared__ bool last_block;

  const int lane = threadIdx.x % kWarp;
  const int warp = threadIdx.x / kWarp;
  const int64_t row_step = static_cast<int64_t>(blockDim.x / kWarp) * gridDim.x;
  const int64_t pieces = nc / N;  // N divides nc on the 16-byte path
  constexpr int64_t kBatch = static_cast<int64_t>(kWarp) * kK4Unroll;

  // first batch of this warp's first row, in flight while rc is staged
  int64_t i = blockIdx.x + static_cast<int64_t>(warp) * gridDim.x;
  T warp_part = T(0);  // rn . z over this warp's rows, in row order
  Piece<T, N> m[kK4Unroll];
  if (i < nc) {
    const T* row = cinv + i * nc;
#pragma unroll
    for (int u = 0; u < kK4Unroll; ++u) {
      const int64_t k = lane + static_cast<int64_t>(u) * kWarp;
      if (k < pieces) m[u] = load_streaming<T, N>(row + k * N);
    }
  }
  // rc into shared memory, N words a thread (rc_wide: its base is aligned)
  if (N > 1 && rc_wide) {
#pragma unroll 2
    for (int64_t k = threadIdx.x; k < pieces; k += blockDim.x) {
      *reinterpret_cast<Piece<T, N>*>(rc_s + k * N) =
          *reinterpret_cast<const Piece<T, N>*>(rc + k * N);
    }
  } else {
#pragma unroll 4
    for (int64_t k = threadIdx.x; k < nc; k += blockDim.x) rc_s[k] = __ldg(rc + k);
  }
  __syncthreads();

  for (; i < nc; i += row_step) {
    const T* row = cinv + i * nc;
    // the row's s and rn, first 32 columns, fetched ahead of the product
    const int64_t e0 = i * gs + lane;
    T s0 = T(0), rn0 = T(0);
    if (lane < gs) {
      s0 = __ldg(s + e0);
      rn0 = __ldg(rn + e0);
    }
    T acc = T(0);
    for (int64_t base = 0; base < pieces; base += kBatch) {
#pragma unroll
      for (int u = 0; u < kK4Unroll; ++u) {
        const int64_t k = base + lane + static_cast<int64_t>(u) * kWarp;
        if (k < pieces) {
          const Piece<T, N> v = *reinterpret_cast<const Piece<T, N>*>(rc_s + k * N);
#pragma unroll
          for (int q = 0; q < N; ++q) acc += m[u].v[q] * v.v[q];
        }
      }
      // next batch: of this row, or the first of this warp's next row
      const bool more = base + kBatch < pieces;
      const T* next = more ? row : row + row_step * nc;
      const int64_t next_base = more ? base + kBatch : 0;
      if (more || i + row_step < nc) {
#pragma unroll
        for (int u = 0; u < kK4Unroll; ++u) {
          const int64_t k = next_base + lane + static_cast<int64_t>(u) * kWarp;
          if (k < pieces) m[u] = load_streaming<T, N>(next + k * N);
        }
      }
    }
    const T zc = warp_sum(acc);
    T part = T(0);
    if (lane < gs) {
      const T zz = s0 + zc;
      z[e0] = zz;
      part = rn0 * zz;
    }
    for (int j = lane + kWarp; j < gs; j += kWarp) {
      const int64_t e = i * gs + j;
      const T zz = __ldg(s + e) + zc;
      z[e] = zz;
      part += __ldg(rn + e) * zz;
    }
    warp_part += warp_sum(part);
  }
  // this block's partial: its warps' sums, added in warp order
  if (lane == 0) scratch[warp] = warp_part;
  __syncthreads();
  if (threadIdx.x == 0) {
    T block_part = T(0);
    for (int w = 0; w < static_cast<int>(blockDim.x) / kWarp; ++w) block_part += scratch[w];
    partial[blockIdx.x] = block_part;
    __threadfence();
    last_block = atomicAdd(counter, 1u) == gridDim.x - 1;
  }

  // the last block to finish sums the blocks' partials
  __syncthreads();
  if (!last_block) return;
  __threadfence();
  const T total = block_sum_fixed(partial, gridDim.x, scratch);
  if (threadIdx.x == 0) {
    *rz = total;
    *counter = 0u;
  }
}

template <typename T>
int launch_k3(const T* alpha, const T* x, const T* r, const T* p, const T* ap,
              const T* inv, T* xn, T* rn, T* s, T* rc, int64_t ns, int64_t gs,
              cudaStream_t stream) {
  if (gs < 1 || gs > 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (ns > 0) {
    if (gs == kWarp) {
      const int64_t blocks = (ns + kRowsPerBlock - 1) / kRowsPerBlock;
      agg_smooth_restrict_32<T><<<static_cast<unsigned>(blocks), kWarp * kRowsPerBlock, 0,
                                  stream>>>(alpha, x, r, p, ap, inv, xn, rn, s, rc, ns);
    } else {
      agg_smooth_restrict_any<T><<<static_cast<unsigned>(ns), static_cast<unsigned>(gs),
                                   gs * sizeof(T), stream>>>(alpha, x, r, p, ap, inv, xn,
                                                             rn, s, rc, static_cast<int>(gs));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int N>
int launch_k4_rows(const T* cinv, const T* rc, const T* s, const T* rn, T* z, T* partial,
                   unsigned* counter, T* rz, int64_t nc, int gs, int64_t blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  int64_t warps = (nc + blocks - 1) / blocks;
  if (warps > kK4MaxThreads / kWarp) warps = kK4MaxThreads / kWarp;
  const size_t shared = static_cast<size_t>(nc) * sizeof(T);
  auto kernel = coarse_prolong_rows<T, N>;
  if (shared > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<static_cast<unsigned>(blocks), static_cast<unsigned>(warps * kWarp), shared,
           stream>>>(cinv, rc, s, rn, z, partial, counter, rz, nc, gs,
                     reinterpret_cast<uintptr_t>(rc) % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_k4(const T* cinv, const T* rc, const T* s, const T* rn, T* z, T* partial,
              unsigned* counter, T* rz, int64_t nc, int64_t gs, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (gs < 1 || nc < 1 || gs > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  // rc has to fit one thread block's shared memory beside the sum's scratch
  if (static_cast<size_t>(nc) * sizeof(T) > kK4MaxShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0;
  cudaError_t status = cudaGetDevice(&device);
  if (status == cudaSuccess) {
    status = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (status != cudaSuccess) return static_cast<int>(status);
  int64_t blocks = static_cast<int64_t>(sms) * kK4BlocksPerSM;
  if (blocks > nc) blocks = nc;
  const bool aligned = (nc * sizeof(T)) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(cinv) % 16 == 0;
  const int g = static_cast<int>(gs);
  return aligned ? launch_k4_rows<T, kVec>(cinv, rc, s, rn, z, partial, counter, rz, nc,
                                           g, blocks, stream)
                 : launch_k4_rows<T, 1>(cinv, rc, s, rn, z, partial, counter, rz, nc, g,
                                        blocks, stream);
}

}  // namespace

extern "C" int agg_smooth_restrict_f32(const float* alpha, const float* x, const float* r,
                                       const float* p, const float* ap, const float* inv,
                                       float* xn, float* rn, float* s, float* rc,
                                       int64_t ns, int64_t gs, cudaStream_t stream) {
  return launch_k3<float>(alpha, x, r, p, ap, inv, xn, rn, s, rc, ns, gs, stream);
}

extern "C" int agg_smooth_restrict_f64(const double* alpha, const double* x,
                                       const double* r, const double* p, const double* ap,
                                       const double* inv, double* xn, double* rn,
                                       double* s, double* rc, int64_t ns, int64_t gs,
                                       cudaStream_t stream) {
  return launch_k3<double>(alpha, x, r, p, ap, inv, xn, rn, s, rc, ns, gs, stream);
}

extern "C" int coarse_prolong_dot_f32(const float* cinv, const float* rc, const float* s,
                                      const float* rn, float* z, float* partial,
                                      unsigned* counter, float* rz, int64_t nc,
                                      int64_t gs, cudaStream_t stream) {
  return launch_k4<float>(cinv, rc, s, rn, z, partial, counter, rz, nc, gs, stream);
}

extern "C" int coarse_prolong_dot_f64(const double* cinv, const double* rc,
                                      const double* s, const double* rn, double* z,
                                      double* partial, unsigned* counter, double* rz,
                                      int64_t nc, int64_t gs, cudaStream_t stream) {
  return launch_k4<double>(cinv, rc, s, rn, z, partial, counter, rz, nc, gs, stream);
}
