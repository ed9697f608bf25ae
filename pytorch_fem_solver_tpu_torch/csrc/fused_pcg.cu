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
// - K4: one warp per coarse row i reads row i of coarse_inv coalesced
//   (32 consecutive words per load) against rc through the read-only
//   cache (rc is nc words, 13 KB, shared by every warp), reduces zc[i] by
//   butterfly shuffles, writes z[i, :] and a per-row partial of rn . z.
//   A second one-block kernel sums the ns partials in a fixed order, so rz
//   is the same on every run (no float atomics): repeated solves take the
//   same iteration count.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRowsPerBlock = 4;  // warps (rows) per thread block
constexpr int kSumThreads = 256;  // the partial-sum kernel's block

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

template <typename T>
__global__ void __launch_bounds__(kWarp * kRowsPerBlock)
    coarse_prolong_rows(const T* __restrict__ cinv, const T* __restrict__ rc,
                        const T* __restrict__ s, const T* __restrict__ rn,
                        T* __restrict__ z, T* __restrict__ partial, int64_t nc,
                        int gs) {
  const int lane = threadIdx.x % kWarp;
  const int64_t i = blockIdx.x * static_cast<int64_t>(kRowsPerBlock) + threadIdx.x / kWarp;
  if (i >= nc) return;
  const T* row = cinv + i * nc;
  T acc = T(0);
#pragma unroll 8
  for (int64_t k = lane; k < nc; k += kWarp) acc += __ldg(row + k) * __ldg(rc + k);
  const T zc = warp_sum(acc);
  T part = T(0);
  for (int j = lane; j < gs; j += kWarp) {
    const int64_t e = i * gs + j;
    const T zz = __ldg(s + e) + zc;
    z[e] = zz;
    part += __ldg(rn + e) * zz;
  }
  part = warp_sum(part);
  if (lane == 0) partial[i] = part;
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
    sum_partials(const T* __restrict__ partial, int64_t n, T* __restrict__ out) {
  __shared__ T buf[kSumThreads];
  T acc = T(0);
  for (int64_t k = threadIdx.x; k < n; k += kSumThreads) acc += partial[k];
  buf[threadIdx.x] = acc;
  __syncthreads();
  for (int width = kSumThreads / 2; width > 0; width /= 2) {
    if (threadIdx.x < width) buf[threadIdx.x] += buf[threadIdx.x + width];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = buf[0];
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

template <typename T>
int launch_k4(const T* cinv, const T* rc, const T* s, const T* rn, T* z, T* partial,
              T* rz, int64_t nc, int64_t gs, cudaStream_t stream) {
  if (gs < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nc > 0) {
    const int64_t blocks = (nc + kRowsPerBlock - 1) / kRowsPerBlock;
    coarse_prolong_rows<T><<<static_cast<unsigned>(blocks), kWarp * kRowsPerBlock, 0,
                             stream>>>(cinv, rc, s, rn, z, partial, nc,
                                       static_cast<int>(gs));
  }
  sum_partials<T><<<1, kSumThreads, 0, stream>>>(partial, nc, rz);
  return static_cast<int>(cudaGetLastError());
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
                                      const float* rn, float* z, float* partial, float* rz,
                                      int64_t nc, int64_t gs, cudaStream_t stream) {
  return launch_k4<float>(cinv, rc, s, rn, z, partial, rz, nc, gs, stream);
}

extern "C" int coarse_prolong_dot_f64(const double* cinv, const double* rc,
                                      const double* s, const double* rn, double* z,
                                      double* partial, double* rz, int64_t nc, int64_t gs,
                                      cudaStream_t stream) {
  return launch_k4<double>(cinv, rc, s, rn, z, partial, rz, nc, gs, stream);
}
