// K7: batched inverse of small square matrices by Gauss-Jordan elimination
// without pivoting, pivots k = 0 ... n-1 in order.
//
// Replaces no Pallas kernel: the JAX package's batched_small_inv
// (ops/precondition.py) is plain jnp, a loop of whole-array elementwise
// operations over the (..., n, 2n) augmented matrix [A | I], which XLA fuses
// on a TPU. The port's plain version (_batched_small_inv_plain in
// ops/precondition.py) is the same loop in PyTorch, and on a CUDA card that
// is four launches a pivot, each a full pass over the augmented tensor: at
// the aggregate-block smoother's (4,072, 64, 64) float32 that is 256
// launches moving about 34 GB. This kernel is the elimination the callers
// run on the card: the aggregate-block smoother (gs = 64), the 8 x 8
// block-Jacobi smoothers and the three-level middle blocks (g2 = 32).
//
// What bounds it on an H100: memory. Each matrix is read once and its
// inverse written once, n^2 words each way: at (4,072, 64, 64) float32 that
// is 133 MB, 40 us at 3.35 TB/s; the elimination's 2 n^3 operations a matrix
// (2.1 GFLOP there) take 32 us at the 67 TFLOP/s of the non-tensor units.
//
// Algorithm. The elimination is kept in place, in n x n words: after pivot k
// column j of the store holds the right half's column j for j <= k and the
// left half's for j > k (the other columns of either half are unit vectors).
// Pivot k with p = a[k][k], r = 1 / p:
//   row k:           a[k][j] <- a[k][j] r    (j != k),   a[k][k] <- r
//   rows i != k:     a[i][j] <- a[i][j] - a[i][k] a[k][j] r   (j != k),
//                    a[i][k] <- -a[i][k] r
// which is one update for every word once row k and column k are zeroed
// and their copies patched (row copy 1 at column k, column copy -1 at row
// k):  a[i][j] <- fma(-col[i], row[j] r, a[i][j]).
// Up to n = 128 a matrix smaller than the padded size NP (8, 16, 32, 64 or
// 128: the least at or above n) is padded with the identity, whose pivots
// come last and change no word of the n x n corner; above 128 the n x n
// block is eliminated as it is.
//
// Design, up to n = 128. A thread holds a tile of 8 rows x 4 columns of the
// padded matrix in registers, (NP / 8) (NP / 4) threads a matrix;
// neighbouring threads hold neighbouring 4-column pieces of a row, so a
// row's loads and stores are 16 bytes a thread and coalesced (two pieces a
// thread in float64). Each matrix is read from device memory once and
// written once; every pivot runs in registers, with the copies of row k
// (times r) and of column k broadcast to the matrix's threads:
// - NP >= 64 (128 or 512 threads): one CTA a matrix. The owners of row k,
//   which share one warp with the pivot's owner, take p by a shuffle and
//   write row k times r into shared memory, the owners of column k write
//   the column, one barrier, and every thread reads the 4 and 8 words it
//   needs as 16-byte pieces. The copies are double-buffered by the pivot's
//   parity, so one barrier a pivot suffices: a thread writes buffer k % 2
//   only after the barrier of pivot k - 1, which every thread reaches after
//   reading buffer k % 2 for pivot k - 2.
// - NP <= 32 (2, 8 or 32 threads a matrix): a warp holds 16, 4 or 1 whole
//   matrices, and the copies travel by shuffles within the warp, no
//   barrier and no shared memory.
// The ownership of row k and column k is known at compile time inside the
// pivot loop (the loop over the 8 pivots of a row block is unrolled), so
// the tile stays in registers.
//
// Design, above n = 128 (the sharded aggregate-block smoother's gs of 160,
// 192 and 224). A block of n^2 words no longer fits a CTA's registers
// beside the code's own, so it is kept in dynamic shared memory, one CTA of
// 1024 threads a matrix. The threads tile a 256 x 256 frame: thread
// (tx, ty) holds rows ty + 32 ii and columns tx + 32 jj (ii, jj < 8), so a
// warp's 32 words of a row are consecutive, in device memory (one
// coalesced 128-byte line in float32) and in shared memory (no bank
// conflict: 4-column pieces a thread would make every access a 4-way
// conflict, and the block is read and written n times, loaded once). Every
// word is touched only by its own thread, so the copies of row k (whose 32
// owners are one warp) and of column k are the only words that cross
// threads, double-buffered as above: one barrier a pivot. The block (n^2
// words, rows unpadded) and the copies (4 n) fit one CTA's 227 KB up to
// n = 239 in float32 and n = 168 in float64; the wrapper
// (ops/precondition.py:batched_small_inv) refuses a larger n. Every pivot
// reads and writes the whole block in shared memory, one word a lane: on an
// H100 at (1,024, 192, 192) float32 it takes about 20 times the operations
// bound (PERF.md's kernel table), about twice what the shared memory's
// bandwidth alone would allow.
//
// On an H100 at (4,072, 64, 64) float32 it takes about 3.4 times the byte
// bound (PERF.md's kernel table), and about three quarters of that without
// the update's multiply-adds: the 64 pivot steps (a barrier, a round trip
// through shared memory and the owners' branches each) bound it, not the
// memory and not the arithmetic.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "pieces.cuh"

namespace {

constexpr int kTR = 8;            // rows of a thread's tile
constexpr int kTC = 4;            // columns of a thread's tile
constexpr int kWarpCta = 256;     // threads of a CTA of the warp kernel
constexpr int kSharedCg = 32;     // threads along a row of the shared kernel
constexpr int kSharedRg = 32;     // threads along a column of the shared kernel
constexpr int kSharedTr = 8;      // rows a thread of the shared kernel holds
constexpr int kSharedTc = 8;      // columns it holds
constexpr int kSharedMaxN = kSharedRg * kSharedTr;  // 256, = kSharedCg kSharedTc
constexpr unsigned kFull = 0xffffffffu;

template <int NP>
__host__ __device__ constexpr int threads_per_matrix() {
  return (NP / kTR) * (NP / kTC);
}

template <typename T>
__device__ __forceinline__ T fma_(T a, T b, T c);
template <>
__device__ __forceinline__ float fma_<float>(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
template <>
__device__ __forceinline__ double fma_<double>(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

// The tile of rows r0.. and columns c0.. of the padded matrix: words of the
// n x n input inside it, the identity outside. vec: n % 4 == 0 and both
// arrays on a 16-byte boundary, so a row's 4 words are whole pieces.
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ m, int n, bool vec, int r0,
                                          int c0, T (&a)[kTR][kTC]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int ii = 0; ii < kTR; ++ii) {
    const int row = r0 + ii;
    if (vec && row < n && c0 < n) {
#pragma unroll
      for (int p = 0; p < kTC / V; ++p) {
        const Piece<T, V> piece = load_streaming<T, V>(m + row * n + c0 + p * V);
#pragma unroll
        for (int v = 0; v < V; ++v) a[ii][p * V + v] = piece.v[v];
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kTC; ++jj) {
        const int col = c0 + jj;
        a[ii][jj] = row < n && col < n ? m[row * n + col] : T(row == col ? 1 : 0);
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void store_tile(T* __restrict__ m, int n, bool vec, int r0, int c0,
                                           const T (&a)[kTR][kTC]) {
  constexpr int V = 16 / sizeof(T);
#pragma unroll
  for (int ii = 0; ii < kTR; ++ii) {
    const int row = r0 + ii;
    if (row >= n || c0 >= n) continue;
    if (vec) {
#pragma unroll
      for (int p = 0; p < kTC / V; ++p) {
        Piece<T, V> piece;
#pragma unroll
        for (int v = 0; v < V; ++v) piece.v[v] = a[ii][p * V + v];
        *reinterpret_cast<Piece<T, V>*>(m + row * n + c0 + p * V) = piece;
      }
    } else {
#pragma unroll
      for (int jj = 0; jj < kTC; ++jj) {
        if (c0 + jj < n) m[row * n + c0 + jj] = a[ii][jj];
      }
    }
  }
}

// The update of one pivot once the row copy (times r) and the column copy
// are in registers.
template <typename T>
__device__ __forceinline__ void update(T (&a)[kTR][kTC], const T (&pr)[kTC], const T (&c)[kTR]) {
#pragma unroll
  for (int ii = 0; ii < kTR; ++ii) {
#pragma unroll
    for (int jj = 0; jj < kTC; ++jj) a[ii][jj] = fma_(-c[ii], pr[jj], a[ii][jj]);
  }
}

// NP >= 64: one CTA of (NP / 8) (NP / 4) threads a matrix.
template <typename T, int NP>
__global__ void __launch_bounds__(threads_per_matrix<NP>())
    small_inv_cta(const T* __restrict__ in, T* __restrict__ out, int n, bool vec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int CG = NP / kTC;  // threads along a row
  constexpr int RB = NP / kTR;  // row blocks
  __shared__ __align__(16) T row_buf[2][NP];
  __shared__ __align__(16) T col_buf[2][NP];
  const int tx = static_cast<int>(threadIdx.x) % CG;
  const int ty = static_cast<int>(threadIdx.x) / CG;
  const int r0 = ty * kTR, c0 = tx * kTC;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n * n;
  T a[kTR][kTC];
  load_tile<T>(in + base, n, vec, r0, c0, a);
  for (int kb = 0; kb < RB; ++kb) {
#pragma unroll
    for (int q = 0; q < kTR; ++q) {
      const int k = kb * kTR + q;
      const int buf = q & 1;   // k % 2, since kTR is even
      const int jq = q % kTC;  // column k's place in its owner's tile
      const bool col_owner = tx == k / kTC;
      // the owners of row k share one warp, which holds the pivot's owner
      const T p = __shfl_sync(kFull, a[q][jq], (kb * CG + k / kTC) % 32);
      if (ty == kb) {  // owners of row k: its copy, times r
        const T r = T(1) / p;
        T w[kTC];
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) {
          w[jj] = c0 + jj == k ? r : a[q][jj] * r;
          a[q][jj] = T(0);
        }
#pragma unroll
        for (int s = 0; s < kTC / V; ++s) {
          Piece<T, V> piece;
#pragma unroll
          for (int v = 0; v < V; ++v) piece.v[v] = w[s * V + v];
          *reinterpret_cast<Piece<T, V>*>(&row_buf[buf][c0 + s * V]) = piece;
        }
      }
      if (col_owner) {  // owners of column k
        T w[kTR];
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) {
          w[ii] = r0 + ii == k ? T(-1) : a[ii][jq];
          a[ii][jq] = T(0);
        }
#pragma unroll
        for (int s = 0; s < kTR / V; ++s) {
          Piece<T, V> piece;
#pragma unroll
          for (int v = 0; v < V; ++v) piece.v[v] = w[s * V + v];
          *reinterpret_cast<Piece<T, V>*>(&col_buf[buf][r0 + s * V]) = piece;
        }
      }
      __syncthreads();
      T pr[kTC], c[kTR];
#pragma unroll
      for (int s = 0; s < kTC / V; ++s) {
        const Piece<T, V> piece = *reinterpret_cast<const Piece<T, V>*>(&row_buf[buf][c0 + s * V]);
#pragma unroll
        for (int v = 0; v < V; ++v) pr[s * V + v] = piece.v[v];
      }
#pragma unroll
      for (int s = 0; s < kTR / V; ++s) {
        const Piece<T, V> piece = *reinterpret_cast<const Piece<T, V>*>(&col_buf[buf][r0 + s * V]);
#pragma unroll
        for (int v = 0; v < V; ++v) c[s * V + v] = piece.v[v];
      }
      update(a, pr, c);
    }
  }
  store_tile<T>(out + base, n, vec, r0, c0, a);
}

// NP <= 32: each group of M = (NP / 8) (NP / 4) lanes of a warp holds one
// matrix; kWarpCta / M matrices a CTA.
template <typename T, int NP>
__global__ void __launch_bounds__(kWarpCta)
    small_inv_warp(const T* __restrict__ in, T* __restrict__ out, int n, bool vec,
                   int64_t batch) {
  constexpr int M = threads_per_matrix<NP>();
  constexpr int CG = NP / kTC;
  constexpr int RB = NP / kTR;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kWarpCta + threadIdx.x;
  if ((first - static_cast<int64_t>(threadIdx.x % 32)) / M >= batch) return;  // the whole warp
  const int lane = static_cast<int>(threadIdx.x % 32);
  const int l = lane % M;
  const int group = lane - l;
  const int tx = l % CG, ty = l / CG;
  const int r0 = ty * kTR, c0 = tx * kTC;
  const int64_t mat = first / M;
  const bool live = mat < batch;  // dead lanes still take part in the shuffles
  const int64_t base = (live ? mat : 0) * n * n;
  T a[kTR][kTC];
  load_tile<T>(in + base, live ? n : 0, vec, r0, c0, a);
  for (int kb = 0; kb < RB; ++kb) {
#pragma unroll
    for (int q = 0; q < kTR; ++q) {
      const int k = kb * kTR + q;
      const int jq = q % kTC;
      const int row_src = group + kb * CG + tx;      // owner of row k, my columns
      const int col_src = group + ty * CG + k / kTC;  // owner of column k, my rows
      const T p = __shfl_sync(kFull, a[q][jq], group + kb * CG + k / kTC);
      T pr[kTC], c[kTR];
#pragma unroll
      for (int jj = 0; jj < kTC; ++jj) pr[jj] = __shfl_sync(kFull, a[q][jj], row_src);
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) c[ii] = __shfl_sync(kFull, a[ii][jq], col_src);
      const T r = T(1) / p;
#pragma unroll
      for (int jj = 0; jj < kTC; ++jj) pr[jj] = c0 + jj == k ? r : pr[jj] * r;
#pragma unroll
      for (int ii = 0; ii < kTR; ++ii) c[ii] = r0 + ii == k ? T(-1) : c[ii];
      if (ty == kb) {
#pragma unroll
        for (int jj = 0; jj < kTC; ++jj) a[q][jj] = T(0);
      }
      if (tx == k / kTC) {
#pragma unroll
        for (int ii = 0; ii < kTR; ++ii) a[ii][jq] = T(0);
      }
      update(a, pr, c);
    }
  }
  if (live) store_tile<T>(out + base, n, vec, r0, c0, a);
}

// 128 < n: one CTA of 1024 threads a matrix, the block in shared memory.
template <typename T>
__global__ void __launch_bounds__(kSharedCg * kSharedRg)
    small_inv_shared(const T* __restrict__ in, T* __restrict__ out, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const s = reinterpret_cast<T*>(smem);  // the block, row-major, n x n
  T* const row_buf = s + n * n;             // [2][n]: row k times r
  T* const col_buf = row_buf + 2 * n;       // [2][n]: column k
  const int tx = static_cast<int>(threadIdx.x) % kSharedCg;
  const int ty = static_cast<int>(threadIdx.x) / kSharedCg;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * n * n;
#pragma unroll
  for (int ii = 0; ii < kSharedTr; ++ii) {
    const int i = ty + kSharedRg * ii;
    if (i >= n) break;
#pragma unroll
    for (int jj = 0; jj < kSharedTc; ++jj) {
      const int j = tx + kSharedCg * jj;
      if (j < n) s[i * n + j] = in[base + i * n + j];
    }
  }
  for (int k = 0; k < n; ++k) {
    T* const rb = row_buf + (k & 1) * n;
    T* const cb = col_buf + (k & 1) * n;
    const int k_tx = k % kSharedCg;  // the owners of column k
    if (ty == k % kSharedRg) {       // the warp that owns row k: its copy, times r
      const T r = T(1) / __shfl_sync(kFull, tx == k_tx ? s[k * n + k] : T(0), k_tx);
#pragma unroll
      for (int jj = 0; jj < kSharedTc; ++jj) {
        const int j = tx + kSharedCg * jj;
        if (j < n) {
          rb[j] = j == k ? r : s[k * n + j] * r;
          s[k * n + j] = T(0);
        }
      }
    }
    if (tx == k_tx) {
#pragma unroll
      for (int ii = 0; ii < kSharedTr; ++ii) {
        const int i = ty + kSharedRg * ii;
        if (i < n) {
          cb[i] = i == k ? T(-1) : s[i * n + k];
          s[i * n + k] = T(0);
        }
      }
    }
    __syncthreads();
    T pr[kSharedTc];
#pragma unroll
    for (int jj = 0; jj < kSharedTc; ++jj) {
      const int j = tx + kSharedCg * jj;
      pr[jj] = j < n ? rb[j] : T(0);
    }
#pragma unroll
    for (int ii = 0; ii < kSharedTr; ++ii) {
      const int i = ty + kSharedRg * ii;
      if (i >= n) break;
      const T c = cb[i];
#pragma unroll
      for (int jj = 0; jj < kSharedTc; ++jj) {
        const int j = tx + kSharedCg * jj;
        if (j < n) s[i * n + j] = fma_(-c, pr[jj], s[i * n + j]);
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < kSharedTr; ++ii) {
    const int i = ty + kSharedRg * ii;
    if (i >= n) break;
#pragma unroll
    for (int jj = 0; jj < kSharedTc; ++jj) {
      const int j = tx + kSharedCg * jj;
      if (j < n) out[base + i * n + j] = s[i * n + j];
    }
  }
}

template <typename T>
int launch_shared(const T* in, T* out, int n, int64_t batch, cudaStream_t stream) {
  if (n > kSharedMaxN || batch > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const size_t shared = (static_cast<size_t>(n) * n + 4 * static_cast<size_t>(n)) * sizeof(T);
  int device = 0, most = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (shared > static_cast<size_t>(most)) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = small_inv_shared<T>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shared));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(batch), kSharedCg * kSharedRg, shared, stream>>>(in, out, n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NP>
int launch_np(const T* in, T* out, int n, int64_t batch, cudaStream_t stream) {
  constexpr int M = threads_per_matrix<NP>();
  const bool vec = n % kTC == 0 && reinterpret_cast<uintptr_t>(in) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if constexpr (M <= 32) {
    const int64_t per_cta = kWarpCta / M;
    const int64_t blocks = (batch + per_cta - 1) / per_cta;
    if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    small_inv_warp<T, NP>
        <<<static_cast<unsigned>(blocks), kWarpCta, 0, stream>>>(in, out, n, vec, batch);
  } else {
    if (batch > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
    small_inv_cta<T, NP><<<static_cast<unsigned>(batch), M, 0, stream>>>(in, out, n, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* in, T* out, int n, int64_t batch, cudaStream_t stream) {
  if (n <= 0 || batch <= 0) return static_cast<int>(cudaGetLastError());
  if (n <= 8) return launch_np<T, 8>(in, out, n, batch, stream);
  if (n <= 16) return launch_np<T, 16>(in, out, n, batch, stream);
  if (n <= 32) return launch_np<T, 32>(in, out, n, batch, stream);
  if (n <= 64) return launch_np<T, 64>(in, out, n, batch, stream);
  if (n <= 128) return launch_np<T, 128>(in, out, n, batch, stream);
  return launch_shared<T>(in, out, n, batch, stream);
}

}  // namespace

extern "C" int small_inv_f32(const float* in, float* out, int n, int64_t batch,
                             cudaStream_t stream) {
  return launch<float>(in, out, n, batch, stream);
}

extern "C" int small_inv_f64(const double* in, double* out, int n, int64_t batch,
                             cudaStream_t stream) {
  return launch<double>(in, out, n, batch, stream);
}
