// K6: row gather out[r, b*k + j] = x[cols[r, b], j].
//
// Replaces: the four in-kernel gathers of tools/exp_pallas_gather_probe.py,
// launched by run: k_take (jnp.take of rows), k_taa (take_along_axis with
// broadcast indices), k_idx (advanced indexing) and k_loop (a fori_loop of
// dynamic slices). All four compute this one function, x[cols] laid out as
// (nb, B*k); they differ only in how Mosaic lowers the gather on a TPU, a
// question Hopper does not have: a thread loads from any address.
//
// What bounds it on an H100: memory. It reads the (nb, B) int32 table and
// the rows of x it names and writes (nb, B*k) values, no arithmetic. At the
// SpMV's shape (nb 12,992, B 8, k 8) that is 4.2 MB, about 1.2 us at the
// memory's rate: less than two trips to memory in a row take, so the time
// is the latency of the chain index -> row -> store, and the design keeps
// that chain to one index load and one row load per thread, with every load
// of a thread in flight before its first store.
//
// Design. A slot (r, b) is one row of k values to copy. Where a row is a
// whole number P of 16-byte pieces (k * sizeof(T) % 16 == 0, x on a 16-byte
// boundary; P = 1, 2, 4 or 8, so k = 4, 8, 16, 32 in f32 and 2, 4, 8, 16 in
// f64), the vector kernel gives each slot a group of P neighbouring lanes:
// lane l of the group moves piece l. So a warp's index load reads 32 / P
// neighbouring indices, each of its row loads fetches whole 32-byte sectors,
// and each of its stores writes 512 contiguous bytes. A thread takes S slots
// (S = 1, 2 or 4, the least that fits the grid in one wave of the card),
// strided by the grid, with all S index loads, then all S row loads issued
// before its first store. Slot arithmetic is 32-bit (the launcher checks
// that nb * B * k fits), a row's address one widening multiply-add of its
// index, and k, P and S are template parameters: no division by a runtime
// value. Indices are streamed (read once), rows of x go through the
// read-only path (a column recurs in about B rows).
// Any other k, an x off a 16-byte boundary, or an output past 2^31 words
// take the generic kernel of this file: a thread per slot copying its k
// values one word at a time. gather_plan and gather_slot_map in
// ops/gather.py are the same maps, replayed by a CPU test.
// Indices must lie in [0, rows of x): the kernels do not check them.

#include <cuda_runtime.h>

#include <cstdint>

#include "pieces.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWaveThreads = 2048;  // resident threads per SM on Hopper

template <typename T, int P, int S>
__global__ void __launch_bounds__(kThreads)
    gather_rows_vec(const T* __restrict__ x, const int32_t* __restrict__ cols,
                    T* __restrict__ out, int n_slots) {
  constexpr int V = 16 / sizeof(T);  // words per piece
  constexpr int K = P * V;           // words per row
  const unsigned t = blockIdx.x * kThreads + threadIdx.x;
  const int lane = static_cast<int>(t % P);
  const int group = static_cast<int>(t / P);
  const int groups = static_cast<int>(gridDim.x * (kThreads / P));
  int idx[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = group + s * groups;
    idx[s] = slot < n_slots ? __ldcs(cols + slot) : 0;
  }
  Piece<T, V> row[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    if (group + s * groups < n_slots) {
      row[s] = load_readonly<T, V>(x + static_cast<int64_t>(idx[s]) * K + lane * V);
    }
  }
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const int slot = group + s * groups;
    if (slot < n_slots) *reinterpret_cast<Piece<T, V>*>(out + slot * K + lane * V) = row[s];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gather_rows_any(const T* __restrict__ x, const int32_t* __restrict__ cols,
                    T* __restrict__ out, int64_t n_slots, int k) {
  const int64_t slot = blockIdx.x * static_cast<int64_t>(kThreads) + threadIdx.x;
  if (slot >= n_slots) return;
  const T* src = x + static_cast<int64_t>(__ldcs(cols + slot)) * k;
  T* dst = out + slot * k;
  for (int j = 0; j < k; ++j) dst[j] = __ldg(src + j);
}

template <typename T, int P>
void launch_vec(const T* x, const int32_t* cols, T* out, int n_slots, int sms,
                cudaStream_t stream) {
  const int64_t lanes = static_cast<int64_t>(n_slots) * P;
  const int64_t wave = static_cast<int64_t>(sms) * kWaveThreads;
  // the least S of 1, 2, 4 whose grid fits one wave
  const int S = lanes <= wave ? 1 : (lanes <= 2 * wave ? 2 : 4);
  const int64_t threads = (lanes + S - 1) / S;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  if (S == 1) {
    gather_rows_vec<T, P, 1><<<blocks, kThreads, 0, stream>>>(x, cols, out, n_slots);
  } else if (S == 2) {
    gather_rows_vec<T, P, 2><<<blocks, kThreads, 0, stream>>>(x, cols, out, n_slots);
  } else {
    gather_rows_vec<T, P, 4><<<blocks, kThreads, 0, stream>>>(x, cols, out, n_slots);
  }
}

template <typename T>
int launch(const T* x, const int32_t* cols, T* out, int64_t n_slots, int k,
           cudaStream_t stream) {
  if (n_slots <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  constexpr int V = 16 / sizeof(T);
  const int P = k % V == 0 ? k / V : 0;
  const bool vector = (P == 1 || P == 2 || P == 4 || P == 8) &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0 &&
                      n_slots * k < (int64_t{1} << 31);
  if (!vector) {
    const unsigned blocks = static_cast<unsigned>((n_slots + kThreads - 1) / kThreads);
    gather_rows_any<T><<<blocks, kThreads, 0, stream>>>(x, cols, out, n_slots, k);
    return static_cast<int>(cudaGetLastError());
  }
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int n = static_cast<int>(n_slots);
  if (P == 1) launch_vec<T, 1>(x, cols, out, n, sms, stream);
  if (P == 2) launch_vec<T, 2>(x, cols, out, n, sms, stream);
  if (P == 4) launch_vec<T, 4>(x, cols, out, n, sms, stream);
  if (P == 8) launch_vec<T, 8>(x, cols, out, n, sms, stream);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int gather_rows_f32(const float* x, const int32_t* cols, float* out,
                               int64_t n_slots, int k, cudaStream_t stream) {
  return launch<float>(x, cols, out, n_slots, k, stream);
}

extern "C" int gather_rows_f64(const double* x, const int32_t* cols, double* out,
                               int64_t n_slots, int k, cudaStream_t stream) {
  return launch<double>(x, cols, out, n_slots, k, stream);
}
