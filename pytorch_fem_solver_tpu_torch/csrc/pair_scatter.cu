// K8: the scatter-add of the assembly into the BSR values, with a sink.
//
// Replaces no Pallas kernel: the JAX package's bsr_values_from_local_symmetric
// (ops/bsr.py) is `.at[slots].add(pairs)`, which XLA lowers on a TPU. The
// port's plain version (bsr_add_pairs_symmetric on a CPU tensor) copies the
// canonical pairs out of the element matrices, local[c, i, j] for i <= j
// with the diagonal halved, into a (T P,) tensor, P = n_loc (n_loc + 1) / 2,
// and adds them with index_add_ at entry_slot_sym. Every pair that touches a
// Dirichlet DOF goes to one sink slot, n_values, one past the values. On an
// H100 that is PyTorch's generic index_add_ kernel, whose adds of the
// boundary-touching pairs all land on the sink's one address and queue
// there, behind a copy of the pairs (their gather, then their weight
// product: two tensors of T P words).
//
// This kernel does the same sum without the copy and without the sink:
//   pair_scatter: pair p = c P + q (cell c, local pair q in np.triu_indices
//     order) adds w_q local[c, i_q, j_q] to values[slots[p]], w_q = 1/2 on the
//     diagonal (i_q = j_q) and 1 elsewhere, the element matrices read in
//     place through their three strides;
//   flat_scatter: value p adds data[p * stride] to values[slots[p]] (the
//     load vector's scatter, and every other drop-mode scatter of the port).
// Both add nothing for a slot outside [0, n_values): the sink, and any slot
// the JAX `mode="drop"` would drop. So the sink slot is never written. The
// order of the adds is the atomics' own, as index_add_'s on the card is: the
// float sum of a slot may differ in its last bits from run to run.
//
// What bounds it on an H100: memory and the L2's atomic units. It reads the
// element matrices' upper triangles (by sector: 16 of the 18 sectors of a
// 12 x 12 float32 matrix), the T P slots, and adds into the values buffer
// once a kept pair. At the elasticity cell's (1,572,864, 12, 12) float32
// that is 805 MB of element matrices and 491 MB of int32 slots, about
// 0.39 ms at 3.35 TB/s, plus the buffer's read-modify-write in the L2.
//
// Design. The call's table of local pairs (n_loc (n_loc + 1) / 2 of them)
// is built by each CTA in dynamic shared memory, one int64 a pair: the
// offset i_q s1 + j_q s2, stored as ~offset (negative) on the diagonal,
// where w_q = 1/2. At 8 bytes a pair and at most kMaxSharedBytes a CTA,
// n_loc <= 240 (ops/bsr.py PAIR_SCATTER_MAX_LOC); above 48 KiB the launch
// opts in to the larger carve-out. Each thread then walks the pairs
// p = first, first + stride, ... (stride = the grid's threads), so a warp
// reads 32 neighbouring slots (one 128-byte line) and the words of one or
// two neighbouring cells' matrices. It tracks (c, q) by adding the stride's
// own (c, q) step, so it divides once, at the start. A thread issues the
// loads of kUnroll pairs before their first add; each add is a reduction
// (RED) that returns nothing, and a dropped pair issues none.
//
// On an H100 at the elasticity shape it takes about 2.2 ms, some 4-5 times
// its byte bound (PERF.md's kernel table: the 32-byte sectors of the
// element matrices that hold an upper-triangle word, 16 of a 12 x 12
// float32 matrix's 18, the slots, and a read and a write of each value
// sector it adds into), against 23.2 ms for index_add_ of the copied
// pairs: the rate of the adds in the L2, not the bytes, bounds it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxSharedBytes = 227 * 1024;  // an H100 CTA's opt-in maximum
constexpr int64_t kDefaultSharedBytes = 48 * 1024;
constexpr int kUnroll = 4;
constexpr int kCtasPerSm = 8;  // resident CTAs of kThreads on one SM, 2048 threads

__device__ __forceinline__ int32_t load_slot(const int32_t* p) { return __ldcs(p); }
__device__ __forceinline__ int64_t load_slot(const int64_t* p) {
  return static_cast<int64_t>(__ldcs(reinterpret_cast<const long long*>(p)));
}

template <typename I>
__device__ __forceinline__ bool kept(I slot, int64_t n_values) {
  return static_cast<int64_t>(slot) >= 0 && static_cast<int64_t>(slot) < n_values;
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    pair_scatter(const T* __restrict__ local, int64_t s0, int64_t s1, int64_t s2, int n_loc,
                 const I* __restrict__ slots, int64_t n_pairs, T* __restrict__ values,
                 int64_t n_values) {
  extern __shared__ int64_t table[];  // P entries: offset, or ~offset on the diagonal
  const int P = n_loc * (n_loc + 1) / 2;
  for (int q = threadIdx.x; q < P; q += kThreads) {
    int i = 0, r = q;  // row i of the upper triangle holds n_loc - i pairs
    while (r >= n_loc - i) {
      r -= n_loc - i;
      ++i;
    }
    const int j = i + r;
    const int64_t offset = i * s1 + j * s2;
    table[q] = i == j ? ~offset : offset;
  }
  __syncthreads();
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t dc = stride / P;
  const int dq = static_cast<int>(stride - dc * P);
  int64_t p = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  int64_t c = p / P;
  int q = static_cast<int>(p - c * P);
  while (p < n_pairs) {
    I slot[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (p < n_pairs) {
        slot[u] = load_slot(slots + p);
        const int64_t t = table[q];
        const bool diagonal = t < 0;
        v[u] = __ldcs(local + c * s0 + (diagonal ? ~t : t)) * (diagonal ? T(0.5) : T(1));
      } else {
        slot[u] = I(-1);
      }
      p += stride;
      c += dc;
      q += dq;
      if (q >= P) {
        q -= P;
        ++c;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kept(slot[u], n_values)) atomicAdd(values + slot[u], v[u]);
    }
  }
}

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    flat_scatter(const T* __restrict__ data, int64_t data_stride, const I* __restrict__ slots,
                 int64_t n, T* __restrict__ values, int64_t n_values) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t p0 = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; p0 < n;
       p0 += kUnroll * stride) {
    I slot[kUnroll];
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t p = p0 + u * stride;
      slot[u] = p < n ? load_slot(slots + p) : I(-1);
      v[u] = p < n ? __ldcs(data + p * data_stride) : T(0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (kept(slot[u], n_values)) atomicAdd(values + slot[u], v[u]);
    }
  }
}

// One wave of the current card, or fewer CTAs where the work is smaller.
int grid_for(int64_t n, int* grid) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t wanted = (n + kThreads - 1) / kThreads;
  const int64_t wave = static_cast<int64_t>(sms) * kCtasPerSm;
  *grid = static_cast<int>(wanted < wave ? wanted : wave);
  return 0;
}

template <typename T, typename I>
int launch_pairs(const T* local, int64_t s0, int64_t s1, int64_t s2, int n_loc, const I* slots,
                 int64_t n_pairs, T* values, int64_t n_values, cudaStream_t stream) {
  const int64_t shared = static_cast<int64_t>(n_loc) * (n_loc + 1) / 2 * sizeof(int64_t);
  if (n_loc < 1 || shared > kMaxSharedBytes || n_pairs < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pairs == 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  int err = grid_for(n_pairs, &grid);
  if (err) return err;
  if (shared > kDefaultSharedBytes) {
    err = static_cast<int>(cudaFuncSetAttribute(
        pair_scatter<T, I>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared)));
    if (err) return err;
  }
  pair_scatter<T, I><<<grid, kThreads, shared, stream>>>(local, s0, s1, s2, n_loc, slots,
                                                          n_pairs, values, n_values);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_flat(const T* data, int64_t data_stride, const I* slots, int64_t n, T* values,
                int64_t n_values, cudaStream_t stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaGetLastError());
  int grid = 0;
  const int err = grid_for(n, &grid);
  if (err) return err;
  flat_scatter<T, I><<<grid, kThreads, 0, stream>>>(data, data_stride, slots, n, values,
                                                     n_values);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define PAIR_SCATTER(SUFFIX, T, I)                                                            \
  extern "C" int pair_scatter_##SUFFIX(const T* local, int64_t s0, int64_t s1, int64_t s2,     \
                                       int n_loc, const I* slots, int64_t n_pairs, T* values,  \
                                       int64_t n_values, cudaStream_t stream) {                \
    return launch_pairs<T, I>(local, s0, s1, s2, n_loc, slots, n_pairs, values, n_values,      \
                              stream);                                                         \
  }                                                                                            \
  extern "C" int flat_scatter_##SUFFIX(const T* data, int64_t data_stride, const I* slots,     \
                                       int64_t n, T* values, int64_t n_values,                 \
                                       cudaStream_t stream) {                                  \
    return launch_flat<T, I>(data, data_stride, slots, n, values, n_values, stream);           \
  }

PAIR_SCATTER(i32_f32, float, int32_t)
PAIR_SCATTER(i32_f64, double, int32_t)
PAIR_SCATTER(i64_f32, float, int64_t)
PAIR_SCATTER(i64_f64, double, int64_t)
