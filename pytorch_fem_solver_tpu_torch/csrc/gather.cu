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
// the rows of x it names and writes (nb, B*k) values, no arithmetic.
//
// Design: one thread per output value. The threads of a warp write 32
// consecutive values, so every store is coalesced; a row of x is k
// consecutive values, so with k = 8 in f32 each group of 8 threads reads
// one 32-byte sector. The index is read once per output value (the k
// threads of a group read the same word, served by one sector). Indices
// must lie in [0, rows of x): the kernel does not check them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename T>
__global__ void gather_rows_kernel(const T* __restrict__ x,
                                   const int32_t* __restrict__ cols,
                                   T* __restrict__ out, int64_t n_out, int k) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n_out) return;
  const int64_t slot = i / k;  // (r, b) flattened: cols is (nb, B) row-major
  const int j = static_cast<int>(i - slot * k);
  out[i] = x[static_cast<int64_t>(cols[slot]) * k + j];
}

template <typename T>
int launch(const T* x, const int32_t* cols, T* out, int64_t n_slots, int k,
           cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int64_t n_out = n_slots * k;
  if (n_out > 0) {
    const int64_t blocks = (n_out + kThreads - 1) / kThreads;
    gather_rows_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
        x, cols, out, n_out, k);
  }
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
