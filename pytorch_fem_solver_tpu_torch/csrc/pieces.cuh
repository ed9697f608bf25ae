// 16-byte pieces and the loads that fetch them, shared by the kernel sources.
#pragma once

#include <cuda_runtime.h>

// One aligned piece of N words: 16 bytes for (float, 4) and (double, 2).
template <typename T, int N>
struct alignas(N * sizeof(T)) Piece {
  T v[N];
};

// A piece through the read-only path, cached as any other load.
template <typename T, int N>
__device__ __forceinline__ Piece<T, N> load_readonly(const T* p);
template <>
__device__ __forceinline__ Piece<float, 4> load_readonly<float, 4>(const float* p) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  return {{a.x, a.y, a.z, a.w}};
}
template <>
__device__ __forceinline__ Piece<double, 2> load_readonly<double, 2>(const double* p) {
  const double2 a = __ldg(reinterpret_cast<const double2*>(p));
  return {{a.x, a.y}};
}
template <>
__device__ __forceinline__ Piece<float, 1> load_readonly<float, 1>(const float* p) {
  return {{__ldg(p)}};
}
template <>
__device__ __forceinline__ Piece<double, 1> load_readonly<double, 1>(const double* p) {
  return {{__ldg(p)}};
}

// A piece through a streaming load: its lines are the first the caches evict.
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
